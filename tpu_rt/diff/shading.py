"""Differentiable shading: pixel colors as smooth functions of geometry and
materials.

The reference precomputes quantized headlight-shaded colors per triangle
(Scene.cc:37,80) and looks them up in the reconstruct kernel.  The
differentiable path recomputes the same shading model from raw vertices and
float materials so pixels carry gradients:

    normal  = normalize(cross(v1-v0, v2-v0))        (Scene.cc:75)
    lambert = dot(normal, normalize(1,2,3))*0.5+0.5 (Scene.cc:37,80)
    color   = material_rgb * lambert                 per hit triangle
    miss    = background (0.2, 0.4, 0.8)
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from tpu_rt.core.types import FlatBVH, Rays
from tpu_rt.diff.tracer import trace_diff
from tpu_rt.shade.reconstruct import BG_COLOR

LIGHT = np.array([1.0, 2.0, 3.0], np.float32)
LIGHT = LIGHT / np.linalg.norm(LIGHT)


def shade_hits_diff(hits_tri, vtx_pos, tri_vtx_index, tri_material):
    """Per-ray RGB from hit ids, differentiable w.r.t. vtx_pos and
    tri_material.  Misses get the background color.

    Computed as a dense per-TRIANGLE Lambert color table followed by one
    per-ray table gather: the shading model depends on the triangle only,
    so the geometry work is [T]-sized dense math, the per-ray part is a
    single [N] gather of 12 B rows, and the backward pass is one
    scatter-add into the [T,3] table followed by dense per-triangle VJPs
    instead of per-ray vertex gathers.  The Lambert dot is pinned to full
    float32 (a GPU would otherwise run it in TF32)."""
    hit = hits_tri >= 0
    tri_c = jnp.clip(hits_tri, 0, max(0, tri_vtx_index.shape[0] - 1))
    v0 = vtx_pos[tri_vtx_index[:, 0]]
    v1 = vtx_pos[tri_vtx_index[:, 1]]
    v2 = vtx_pos[tri_vtx_index[:, 2]]
    n = jnp.cross(v1 - v0, v2 - v0)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
    lambert = jnp.matmul(n, jnp.asarray(LIGHT),
                         precision=jax.lax.Precision.HIGHEST) * 0.5 + 0.5
    table = tri_material[:, :3] * lambert[:, None]      # [T,3]
    color = table[tri_c]                                # one [N] gather
    return jnp.where(hit[:, None], color, jnp.asarray(BG_COLOR[:3])[None, :])


def render_image_diff(flat: FlatBVH, rays: Rays, vtx_pos, tri_vtx_index, tri_material):
    """Differentiable primary-ray render: [N,3] RGB per ray.

    Gradients flow to vtx_pos both through shading normals and through the
    hit-distance path (trace_diff), and to tri_material through shading.
    """
    hits = trace_diff(False, flat, rays, vtx_pos, tri_vtx_index)
    return shade_hits_diff(hits.tri, vtx_pos, tri_vtx_index, tri_material)
