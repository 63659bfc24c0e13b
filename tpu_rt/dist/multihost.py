"""Multi-host initialization + scaling-efficiency measurement.

The reference is single-process/single-GPU (SURVEY.md §2.3); multi-card
scaling is a component this framework adds (BASELINE.md north star:
>=85% rays/s scaling efficiency from 1 card to many).  Protocol:

- every process calls init_multihost() (jax.distributed.initialize with
  the coordinator address, process count and process id from its
  arguments or the JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
  JAX_PROCESS_ID env vars — nothing discovers a cluster by itself);
- the ray mesh (dist.sharding.make_ray_mesh) then spans all processes'
  devices; rays are data-parallel over the ("rays",) axis so cross-host
  traffic is confined to batch boundaries and the psum'd gradients.
"""

from __future__ import annotations

import os
import time

import numpy as np

import jax

_initialized = False


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> int:
    """Initialize jax.distributed for a multi-host run (idempotent).

    Returns the process count.  Single-process (no coordinator env, no
    args) is a no-op returning 1, so callers can invoke unconditionally.
    """
    global _initialized
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes in (None, 1):
        return 1
    if not _initialized:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        _initialized = True
    return jax.process_count()


def measure_scaling(flat, rays, routing=None, tables=None,
                    any_hit: bool = False, repeats: int = 3,
                    warmup: int = 1, mode: str = "weak") -> dict:
    """Rays/s at 1 device vs all devices on the current platform; returns
    {"n_devices", "rate_1", "rate_n", "efficiency"} where efficiency =
    (rate_n / n) / rate_1 (the BASELINE north-star >=0.85 metric).

    rays: the PER-DEVICE batch in "weak" mode (default: every device
    traces this batch, the throughput-scaling convention the rays/s
    north star implies), or the GLOBAL batch in "strong" mode (fixed
    total work split across devices — per-device fixed overheads then
    count against efficiency).
    Each timed trace ends in jax.block_until_ready.
    """
    import jax.numpy as jnp

    from tpu_rt.dist.sharding import make_ray_mesh, replicate_bvh, shard_rays, trace_sharded
    from tpu_rt.trace import _xla_routing

    if routing is None:
        if tables is not None:
            raise ValueError(
                "tables given without routing: pass the (routing, tables) "
                "pair from make_routing_tracer together, or neither")
        routing, tables = _xla_routing, None  # resolved per-mesh below

    devices = jax.devices()
    n = len(devices)

    def rate(mesh_devices) -> float:
        mesh = make_ray_mesh(mesh_devices)
        k = len(mesh_devices)
        if mode == "weak":
            sub = (rays if k == 1 else jax.tree_util.tree_map(
                lambda x: jnp.concatenate([x] * k), rays))
            take = int(sub.origin.shape[0])
        else:
            take = (rays.origin.shape[0] // k) * k
            sub = jax.tree_util.tree_map(lambda x: x[:take], rays)
        srays = shard_rays(sub, mesh)
        if tables is None:
            tb = replicate_bvh(flat, mesh)
        else:
            rep = jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec())
            tb = jax.tree_util.tree_map(
                lambda x: jax.device_put(x, rep), tables)
        def once():
            return jax.block_until_ready(trace_sharded(
                flat, srays, mesh, any_hit=any_hit, routing=routing,
                tables=tb))
        for _ in range(warmup):
            once()
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            once()
            best = min(best, time.perf_counter() - t0)
        return take / best

    rate_1 = rate(devices[:1])
    rate_n = rate(devices) if n > 1 else rate_1
    eff = (rate_n / n) / rate_1 if rate_1 > 0 else float("nan")
    out = {
        "n_devices": n,
        "rate_1_rays_per_s": rate_1,
        "rate_n_rays_per_s": rate_n,
        "per_device_rate_n": rate_n / n,
        "efficiency": eff,
    }
    if mode == "strong" and n > 1:
        # Decomposition: strong-mode loss =
        # (a) each device traces a 1/n-size batch, which amortizes fixed
        # per-call cost worse, + (b) any overhead the sharding mechanism
        # itself adds.  rate_1_small = ONE device on a 1/n batch isolates
        # (a); mechanism_efficiency = rate_n / (n * rate_1_small)
        # isolates (b) — ~1.0 means shard_map adds no per-device cost
        # and the strong-mode number is purely batch amortization.
        small = jax.tree_util.tree_map(
            lambda x: x[: max(1, (x.shape[0] // n))], rays)
        saved = rays
        try:
            rays = small
            rate_1_small = rate(devices[:1])
        finally:
            rays = saved
        out["rate_1_small_rays_per_s"] = rate_1_small
        out["mechanism_efficiency"] = (
            (rate_n / n) / rate_1_small if rate_1_small > 0 else float("nan"))
    return out
