"""Differentiable tracing: gradients through hit distance / barycentrics.

The reference has no autodiff; this is the framework's extension
(BASELINE.json north star: pixel gradients w.r.t. vertex positions and
materials).  Design:

- BVH traversal (which triangle a ray hits) is discrete *routing* — a
  stop-gradient operation, like argmax.  The fast Woop wavefront tracer runs
  under stop_gradient, so autodiff never sees its while_loop.
- Given the routing, (t, u, v) are recomputed differentiably from the hit
  triangle's *raw vertices* via Moller-Trumbore.  The returned values are
  therefore a smooth function of (rays, vtx_pos) with exact JAX gradients —
  no custom_vjp, no differentiating through the Woop tables.

This also makes the forward value self-consistent with its derivative: what
you differentiate is exactly what you get (up to the routing discontinuity
at silhouettes, which is the standard differentiable-rendering caveat).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpu_rt.core.types import FlatBVH, Hits, Rays
from tpu_rt.trace.xla_tracer import trace_wavefront


def moller_trumbore_tuv(o, d, v0, v1, v2):
    """Differentiable (t, u, v) of rays against given triangles ([N,3] each).
    Same intersection equations as the CPU oracle (reference
    Intersect::RayTriangle, src/rt/Util.cc:50-94)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = 1.0 / det
    tvec = o - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    return t, u, v


def trace_diff(any_hit: bool, flat: FlatBVH, rays: Rays, vtx_pos: jnp.ndarray,
               tri_vtx_index: jnp.ndarray, raw: Hits | None = None) -> Hits:
    """Differentiable trace.  `flat` must be built from the same
    (vtx_pos, tri_vtx_index): it carries the routing; the raw arrays carry
    the derivative.  Returns Hits whose t/u/v are differentiable w.r.t.
    rays and vtx_pos (misses keep t = tmax with zero gradient).

    raw: optional precomputed routing Hits (e.g. from the CUDA kernel) —
    routing is discrete, so ANY correct tracer's output can carry it; when
    given, `flat` is unused."""
    frozen_rays = jax.tree_util.tree_map(jax.lax.stop_gradient, rays)
    if raw is None:
        frozen_flat = jax.tree_util.tree_map(jax.lax.stop_gradient, flat)
        raw = trace_wavefront(frozen_flat, frozen_rays, any_hit=any_hit)
    else:
        raw = jax.tree_util.tree_map(jax.lax.stop_gradient, raw)

    hit = raw.tri >= 0
    tri_c = jnp.clip(raw.tri, 0, max(0, tri_vtx_index.shape[0] - 1))
    idx = tri_vtx_index[tri_c]
    v0 = vtx_pos[idx[:, 0]]
    v1 = vtx_pos[idx[:, 1]]
    v2 = vtx_pos[idx[:, 2]]
    t, u, v = moller_trumbore_tuv(rays.origin, rays.dirn, v0, v1, v2)

    zero = jnp.zeros_like(t)
    return Hits(
        tri=raw.tri,
        t=jnp.where(hit, t, raw.t),
        u=jnp.where(hit, u, zero),
        v=jnp.where(hit, v, zero),
    )
