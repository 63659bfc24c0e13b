#!/usr/bin/env python
"""Differentiable-path throughput on the GPU: routing-only, forward
render, and full grad step (forward + backward + psum) in Mray/s.

The routing trace runs on the tracer make_routing_tracer picks (the CUDA
kernel on a GPU); the differentiable recompute + shading are dense XLA
(per-triangle Lambert table + one per-ray gather).  Uses a mesh over all
devices via the same shard_map path as production (tpu_rt.dist.sharding).

Rows reported (one JSON line on stdout):
- routing_s:   the raw routing trace inside shard_map (no diff work) —
               the floor the diff path is measured against;
- forward_s:   differentiable render (routing + shade table + gather);
- grad_step_s: forward + backward + gradient psum;
- diff_overhead_s = forward - routing; backward_s = grad_step - forward;
- psum_bytes: the step's total collective volume (vtx + material grads
  + loss).

Usage: python tools/bench_diff.py [scene] [width] [height]
Env: BD_REPEATS (3), BD_PROFILE=<dir> (jax.profiler trace of one grad
step).  Exits with code 2 when JAX finds no GPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main() -> None:
    scene_name = sys.argv[1] if len(sys.argv) > 1 else "bunny"

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from tpu_rt.bench.device import card_info, require_gpu
    from tpu_rt.bench.workload import FRAME_H, FRAME_W, suite_camera
    from tpu_rt.bvh import load_or_build_bvh
    from tpu_rt.dist import grad_step_sharded, shard_rays
    from tpu_rt.dist.sharding import (AXIS, render_diff_sharded,
                                      replicate_bvh, trace_sharded)
    from tpu_rt.raygen import RayGen
    from tpu_rt.scene import Scene, procedural
    from tpu_rt.compile_cache import configure_compile_cache
    from tpu_rt.trace import device_bvh, make_routing_tracer

    configure_compile_cache()
    device = require_gpu("bench_diff.py")

    width = int(sys.argv[2]) if len(sys.argv) > 2 else FRAME_W
    height = int(sys.argv[3]) if len(sys.argv) > 3 else FRAME_H
    repeats = int(os.environ.get("BD_REPEATS", 3))

    scene = Scene(procedural.scene_by_name(scene_name))
    flat, _ = load_or_build_bvh(scene, cache_dir="bvhcache")
    camera = suite_camera(scene_name, scene)
    rays, _, _ = RayGen().primary(camera, width, height)
    n = int(rays.origin.shape[0])

    devices = np.asarray(jax.devices())
    mesh = Mesh(devices.reshape(-1), (AXIS,))
    routing, kind, tables = make_routing_tracer(flat)
    dflat = replicate_bvh(device_bvh(flat), mesh)
    rtables = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P())), tables)
    srays = shard_rays(rays, mesh)

    vtx = jnp.asarray(scene.vtx_pos)
    tvi = jnp.asarray(scene.tri_vtx_index)
    mat = jnp.asarray(scene.tri_material)
    target = jax.device_put(
        jnp.zeros((n, 3), jnp.float32), NamedSharding(mesh, P(AXIS, None)))

    def routing_only():
        return jax.block_until_ready(trace_sharded(
            dflat, srays, mesh, routing=routing, tables=rtables))

    def fwd():
        return jax.block_until_ready(render_diff_sharded(
            mesh, dflat, srays, vtx, tvi, mat, routing=routing,
            tables=rtables))

    def step():
        return jax.block_until_ready(grad_step_sharded(
            mesh, dflat, srays, vtx, tvi, mat, target, routing=routing,
            tables=rtables))

    out = {"scene": scene_name, "rays": n, "routing": kind,
           "width": width, "height": height, "device": device,
           "card": card_info(),
           "psum_bytes": int(vtx.size * 4 + mat.size * 4 + 4)}
    for name, fn in (("routing", routing_only), ("forward", fwd),
                     ("grad_step", step)):
        fn()
        fn()
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        best = min(times)
        out[f"{name}_s"] = round(best, 5)
        out[f"{name}_mrays"] = round(n / best / 1e6, 3)
        print(f"{name}: {best*1e3:.2f} ms = {n/best/1e6:.2f} Mray/s",
              flush=True)
    out["diff_overhead_s"] = round(out["forward_s"] - out["routing_s"], 5)
    out["backward_s"] = round(out["grad_step_s"] - out["forward_s"], 5)
    out["forward_vs_routing"] = round(out["routing_s"] / out["forward_s"], 3)
    prof = os.environ.get("BD_PROFILE")
    if prof:
        with jax.profiler.trace(prof):
            step()
        out["profile_dir"] = prof
    print(json.dumps(out))


if __name__ == "__main__":
    main()
