"""Multi-chip scaling: rays sharded over a device mesh, geometry replicated.

The reference is single-process single-GPU (SURVEY.md section 2.3); this
layer is a component the framework adds.  Design (mesh -> shardings -> XLA
collectives):

- Mesh: one axis ("rays") over all cards.  The cards of a host are joined
  all to all, so the mesh follows the algorithm alone; across hosts the
  axis only carries batch boundaries.
- Rays are batch-data-parallel: each card traces its shard with an
  *independent* traversal (the CUDA kernel or the XLA wavefront loop).
  shard_map (not plain jit-of-while_loop) is essential: automatic
  partitioning of a while_loop would insert a global all-reduce on the
  loop condition every iteration, and a custom call has no partitioning
  rule; shard_map keeps each card's trace local so there are NO
  collectives in the forward trace.
- BVH + triangle tables are replicated (tens of MB for the reference suite
  — SURVEY.md section 5), broadcast once at upload.
- Backward: per-card vertex/material grads are psum'd (NCCL all-reduce on
  GPUs) — the only communication in the step.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from tpu_rt.core.types import FlatBVH, Hits, Rays
from tpu_rt.diff.shading import shade_hits_diff
from tpu_rt.diff.tracer import trace_diff
from tpu_rt.trace import _xla_routing

AXIS = "rays"

# Routing-tracer plumbing: every sharded entry point takes an optional
# (routing, tables) pair from tpu_rt.trace.make_routing_tracer, so the
# CUDA kernel (not just the XLA wavefront) runs inside shard_map on each
# card.  `routing` is a static argument; routing callables compare equal
# by configuration, so re-creating one does not recompile.


def make_ray_mesh(devices=None) -> Mesh:
    """1-D mesh over all devices (or the given ones) on the ray axis."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), (AXIS,))


def shard_rays(rays: Rays, mesh: Mesh) -> Rays:
    """Place a ray batch sharded over the mesh (pads are the caller's job:
    N must divide by mesh size — use tpu_rt.core.types.pad_rays)."""
    n_dev = mesh.devices.size
    assert rays.origin.shape[0] % n_dev == 0, (
        f"ray count {rays.origin.shape[0]} not divisible by {n_dev} devices; pad_rays first"
    )
    sh1 = NamedSharding(mesh, P(AXIS))
    return Rays(
        origin=jax.device_put(rays.origin, NamedSharding(mesh, P(AXIS, None))),
        dirn=jax.device_put(rays.dirn, NamedSharding(mesh, P(AXIS, None))),
        tmin=jax.device_put(rays.tmin, sh1),
        tmax=jax.device_put(rays.tmax, sh1),
    )


def replicate_bvh(flat: FlatBVH, mesh: Mesh) -> FlatBVH:
    rep = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(jnp.asarray(x), rep), flat)


_RAY_SPEC = Rays(origin=P(AXIS, None), dirn=P(AXIS, None), tmin=P(AXIS),
                 tmax=P(AXIS))
_HIT_SPEC = Hits(tri=P(AXIS), t=P(AXIS), u=P(AXIS), v=P(AXIS))


@partial(jax.jit, static_argnames=("mesh", "any_hit", "routing"))
def _trace_sharded_jit(mesh, any_hit, routing, tables, rays):
    fn = shard_map(
        lambda tb, r: routing(tb, r, any_hit),
        mesh=mesh,
        in_specs=(P(), _RAY_SPEC),
        out_specs=_HIT_SPEC,
        check_vma=False,
    )
    return fn(tables, rays)


def trace_sharded(flat: FlatBVH, rays: Rays, mesh: Mesh, any_hit: bool = False,
                  routing=None, tables=None) -> Hits:
    """Trace with rays sharded across the mesh.  Forward pass has no
    cross-chip communication; each chip runs its own traversal loop.

    routing/tables: from tpu_rt.trace.make_routing_tracer — runs the
    CUDA kernel per card.  Default: XLA wavefront over `flat` (which must
    then be device-resident/replicated)."""
    if routing is None:
        routing, tables = _xla_routing, flat
    return _trace_sharded_jit(mesh, any_hit, routing, tables, rays)


@partial(jax.jit, static_argnames=("mesh", "routing"))
def _render_diff_sharded_jit(mesh, routing, flat, rays, vtx_pos,
                             tri_vtx_index, tri_material, tables):
    def local(f, r, vp, tvi, mat, tb):
        raw = routing(tb, r, False) if routing is not None else None
        hits = trace_diff(False, f, r, vp, tvi, raw=raw)
        return shade_hits_diff(hits.tri, vp, tvi, mat)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), _RAY_SPEC, P(), P(), P(), P()),
        out_specs=P(AXIS, None),
        check_vma=False,
    )
    return fn(flat, rays, vtx_pos, tri_vtx_index, tri_material, tables)


def render_diff_sharded(mesh, flat, rays, vtx_pos, tri_vtx_index,
                        tri_material, routing=None, tables=None):
    """Sharded differentiable render: per-ray RGB, rays sharded, geometry
    replicated.  routing/tables (make_routing_tracer) run the CUDA kernel
    for the stop-gradient routing pass."""
    if routing is None:
        tables = flat  # trace_diff routes via the XLA tracer over `flat`
    return _render_diff_sharded_jit(mesh, routing, flat, rays, vtx_pos,
                                    tri_vtx_index, tri_material, tables)


@partial(jax.jit, static_argnames=("mesh", "routing"))
def _grad_step_sharded_jit(mesh, routing, flat, rays, vtx_pos, tri_vtx_index,
                           tri_material, target, tables):
    def local(f, r, vp, tvi, mat, tgt, tb):
        raw = routing(tb, r, False) if routing is not None else None

        def loss_fn(vp_, mat_):
            hits = trace_diff(False, f, r, vp_, tvi, raw=raw)
            rgb = shade_hits_diff(hits.tri, vp_, tvi, mat_)
            # Mean over the *global* batch: local sum / global count.
            return jnp.sum((rgb - tgt) ** 2)

        loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 1))(vp, mat)
        # The only collectives in the step: gradient + loss reduction.
        loss = jax.lax.psum(loss, AXIS)
        g_vp = jax.lax.psum(grads[0], AXIS)
        g_mat = jax.lax.psum(grads[1], AXIS)
        n_global = r.origin.shape[0] * jax.lax.psum(1, AXIS)
        scale = 1.0 / (n_global * 3)
        return loss * scale, g_vp * scale, g_mat * scale

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), _RAY_SPEC, P(), P(), P(), P(AXIS, None), P()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    return fn(flat, rays, vtx_pos, tri_vtx_index, tri_material, target,
              tables)


COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                  "collective-permute", "all-to-all",
                  "collective-broadcast", "ragged-all-to-all")


def _count_collectives(hlo_text: str) -> dict:
    """Occurrences of each XLA collective op in an HLO module text.
    Counts op INSTRUCTIONS (` = op-name(` / fusion-less start-`op-name`),
    not substrings inside metadata."""
    import re

    out = {}
    for op in COLLECTIVE_OPS:
        # HLO instruction forms: `%name = type op-name(` where type may
        # be a tuple containing spaces, plus the `-start`/`-done` async
        # pair (count starts only, and not `-done`/metadata mentions).
        n = len(re.findall(rf"= [^\n=]* {op}(?:-start)?\(", hlo_text))
        if n:
            out[op] = n
    return out


def collective_audit(mesh, flat, rays, vtx_pos, tri_vtx_index, tri_material,
                     target, routing=None, tables=None) -> dict:
    """Mechanical proof of the zero-forward-collective design (the claim
    in this module's docstring): lower trace_sharded and grad_step_sharded for `mesh`
    and count collective ops in both the pre-optimization StableHLO and
    the compiled HLO.

    Expected: forward trace — ZERO collectives in both; grad step —
    exactly 3 stablehlo.all_reduce (loss + vertex grads + material
    grads psums; the lax.psum(1) device count is constant-folded at
    trace time), compiling to >=1 all-reduce (XLA may combine them) and
    nothing else.  Returns the counts for artifact embedding.
    """
    if routing is None:
        routing, tables = _xla_routing, flat
    fwd = _trace_sharded_jit.lower(mesh, False, routing, tables, rays)
    gs = _grad_step_sharded_jit.lower(mesh, routing, flat, rays, vtx_pos,
                                      tri_vtx_index, tri_material, target,
                                      tables)
    fwd_st = fwd.as_text()
    gs_st = gs.as_text()
    fwd_hlo = fwd.compile().as_text()
    gs_hlo = gs.compile().as_text()

    def st_count(text):
        import re

        return {op: n for op in ("all_reduce", "all_gather",
                                 "reduce_scatter", "collective_permute",
                                 "all_to_all", "collective_broadcast")
                if (n := len(re.findall(rf"stablehlo\.{op}\b", text)))}

    return {
        "n_devices": int(mesh.devices.size),
        "forward_stablehlo": st_count(fwd_st),
        "forward_compiled": _count_collectives(fwd_hlo),
        "grad_step_stablehlo": st_count(gs_st),
        "grad_step_compiled": _count_collectives(gs_hlo),
    }


def grad_step_sharded(mesh, flat, rays, vtx_pos, tri_vtx_index, tri_material,
                      target, routing=None, tables=None):
    """One full 'training step': sharded forward render, L2 image loss
    against `target` ([N,3], sharded like rays), backward with vertex +
    material gradient all-reduce (psum).

    routing/tables (make_routing_tracer): the stop-gradient routing trace
    runs on the CUDA kernel; autodiff only sees the recompute from raw
    vertices, so gradients are unchanged.

    Returns (loss, grad_vtx_pos, grad_tri_material) — all replicated.
    """
    if routing is None:
        tables = flat
    return _grad_step_sharded_jit(mesh, routing, flat, rays, vtx_pos,
                                  tri_vtx_index, tri_material, target, tables)
