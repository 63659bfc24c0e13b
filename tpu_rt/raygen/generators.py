"""Device ray generators (jnp, jit-compiled) — primary / AO / shadow.

Vectorized re-designs of the reference's raygen kernels
(src/rt/ray/RayGenKernels.cu:79-293).  One launch = one jnp expression over
the whole batch; the ID<->slot permutation arrays are returned alongside so
Morton-sorted secondary batches keep their logical addressing
(reference RayBuffer.hh:46-76).

Seeding fixes the reference's reproducibility leak (RayGen.cc:106 uses
rand()): the caller passes an explicit uint32 seed.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from tpu_rt.core.types import Rays

TWO_PI = np.float32(2.0 * np.pi)
GOLDEN = np.uint32(0x9E3779B9)


def _jenkins_mix_jnp(a, b, c):
    u32 = jnp.uint32
    a, b, c = a.astype(u32), b.astype(u32), c.astype(u32)
    a = a - b; a = a - c; a = a ^ (c >> 13)
    b = b - c; b = b - a; b = b ^ (a << 8)
    c = c - a; c = c - b; c = c ^ (b >> 13)
    a = a - b; a = a - c; a = a ^ (c >> 12)
    b = b - c; b = b - a; b = b ^ (a << 16)
    c = c - a; c = c - b; c = c ^ (b >> 5)
    a = a - b; a = a - c; a = a ^ (c >> 3)
    b = b - c; b = b - a; b = b ^ (a << 10)
    c = c - a; c = c - b; c = c ^ (b >> 15)
    return a, b, c


def _halton2_jnp(i):
    v = (jnp.asarray(i, jnp.uint32) + 1).astype(jnp.uint32)
    v = ((v >> 1) & np.uint32(0x55555555)) | ((v & np.uint32(0x55555555)) << 1)
    v = ((v >> 2) & np.uint32(0x33333333)) | ((v & np.uint32(0x33333333)) << 2)
    v = ((v >> 4) & np.uint32(0x0F0F0F0F)) | ((v & np.uint32(0x0F0F0F0F)) << 4)
    v = ((v >> 8) & np.uint32(0x00FF00FF)) | ((v & np.uint32(0x00FF00FF)) << 8)
    v = (v >> 16) | (v << 16)
    return v.astype(jnp.float32) * np.float32(2.0**-32)


def _halton3_jnp(i, iters: int = 21):
    hc = (jnp.asarray(i, jnp.uint32) + 1).astype(jnp.uint32)
    y = jnp.zeros(hc.shape, jnp.float32)
    yadd = jnp.ones(hc.shape, jnp.float32)
    third = np.float32(1.0 / 3.0)
    for _ in range(iters):
        yadd = yadd * third
        y = y + (hc % 3).astype(jnp.float32) * yadd
        hc = hc // 3
    return y


@partial(jax.jit, static_argnames=("width", "height"))
def gen_primary_rays(
    index_to_pixel: jnp.ndarray,
    origin: jnp.ndarray,
    nscreen_to_world: jnp.ndarray,
    width: int,
    height: int,
    max_dist: jnp.ndarray,
):
    """Primary rays in Morton-swizzled pixel order (rayGenPrimaryKernel,
    RayGenKernels.cu:79-113).  Returns (Rays, slot_to_id, id_to_slot)."""
    n = width * height
    task = jnp.arange(n, dtype=jnp.int32)
    pixel = index_to_pixel.astype(jnp.int32)

    px = (pixel % width).astype(jnp.float32)
    py = (pixel // width).astype(jnp.float32)
    sx = 2.0 * (px + 0.5) / width - 1.0
    sy = 2.0 * (py + 0.5) / height - 1.0

    # Transform (sx, sy, 0, 1) by the 4x4 with explicit f32 vector math.
    # A jnp matmul may run in TF32 on a GPU; the perspective inverse has
    # heavy cancellation in w, so full f32 is required here.
    m = nscreen_to_world.astype(jnp.float32)
    world = m[None, :, 0] * sx[:, None] + m[None, :, 1] * sy[:, None] + m[None, :, 3]  # [n,4]
    world_pos = world[:, :3] / world[:, 3:4]
    d = world_pos - origin[None, :]
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)

    rays = Rays(
        origin=jnp.broadcast_to(origin, (n, 3)).astype(jnp.float32),
        dirn=d.astype(jnp.float32),
        tmin=jnp.zeros((n,), jnp.float32),
        tmax=jnp.full((n,), max_dist, jnp.float32),
    )
    slot_to_id = pixel
    id_to_slot = jnp.zeros((n,), jnp.int32).at[pixel].set(task)
    return rays, slot_to_id, id_to_slot


@partial(jax.jit, static_argnames=("num_samples",))
def gen_ao_rays(
    in_origin: jnp.ndarray,   # [R,3] input ray origins
    in_dirn: jnp.ndarray,     # [R,3] input ray directions
    in_t: jnp.ndarray,        # [R] hit t
    in_tri: jnp.ndarray,      # [R] hit tri id (-1 miss)
    tri_normal: jnp.ndarray,  # [T,3] scene triangle normals
    num_samples: int,
    max_dist: jnp.ndarray,
    seed: jnp.ndarray,        # uint32
    task_offset: jnp.ndarray | int = 0,
):
    """AO / diffuse-bounce rays (rayGenAOKernel, RayGenKernels.cu:117-227).

    For each input hit: backtrack epsilon along the ray, build a tangent
    frame around the (front-facing) normal with a per-ray random rotation
    (2x jenkinsMix of seed+taskIdx), then emit num_samples cosine-weighted
    hemisphere directions from the Halton 2/3 sequence.  Misses emit
    degenerate rays (tmax=-1).  Returns (Rays [R*S], slot_to_id, id_to_slot)
    — both identity (RayGenKernels.cu:224-225).
    """
    r = in_origin.shape[0]
    eps = np.float32(1.0e-4)

    origin = in_origin + in_dirn * jnp.maximum(in_t - eps, 0.0)[:, None]

    valid = in_tri >= 0
    tri_c = jnp.clip(in_tri, 0, tri_normal.shape[0] - 1)
    normal = jnp.where(valid[:, None], tri_normal[tri_c], jnp.asarray([[1.0, 0.0, 0.0]], jnp.float32))
    # Flip back-facing normals toward the incoming ray.
    normal = jnp.where(jnp.sum(normal * in_dirn, axis=1, keepdims=True) > 0.0, -normal, normal)

    # Perpendicular construction (RayGenKernels.cu:152-161): default assumes
    # y largest; the z test comes first, then x.
    na = jnp.abs(normal)
    nm = jnp.max(na, axis=1)
    perp_y = jnp.stack([normal[:, 1], -normal[:, 0], jnp.zeros(r, jnp.float32)], axis=1)
    perp_z = jnp.stack([jnp.zeros(r, jnp.float32), normal[:, 2], -normal[:, 1]], axis=1)
    perp_x = jnp.stack([-normal[:, 2], jnp.zeros(r, jnp.float32), normal[:, 0]], axis=1)
    perp = jnp.where(
        (nm == na[:, 2])[:, None],
        perp_z,
        jnp.where((nm == na[:, 0])[:, None], perp_x, perp_y),
    )
    perp = perp / jnp.linalg.norm(perp, axis=1, keepdims=True)
    biperp = jnp.cross(normal, perp)

    task = jnp.arange(r, dtype=jnp.uint32) + jnp.asarray(task_offset, jnp.uint32)
    a = jnp.asarray(seed, jnp.uint32) + task
    b = jnp.full((r,), GOLDEN, jnp.uint32)
    c = jnp.full((r,), GOLDEN, jnp.uint32)
    a, b, c = _jenkins_mix_jnp(a, b, c)
    a, b, c = _jenkins_mix_jnp(a, b, c)
    angle = TWO_PI * c.astype(jnp.float32) * np.float32(2.0**-32)

    ca, sa = jnp.cos(angle)[:, None], jnp.sin(angle)[:, None]
    t0 = perp * ca + biperp * sa
    t1 = -perp * sa + biperp * ca

    # Samples: Halton base-2 (x) / base-3 (y) -> cosine hemisphere.
    i = jnp.arange(num_samples, dtype=jnp.uint32)
    hx = _halton2_jnp(i)  # [S]
    hy = _halton3_jnp(i)
    sangle = TWO_PI * hy
    sr = jnp.sqrt(hx)
    x = sr * jnp.cos(sangle)
    y = sr * jnp.sin(sangle)
    z = jnp.sqrt(jnp.maximum(1.0 - x * x - y * y, 0.0))

    # [R,S,3] = x*t0 + y*t1 + z*normal
    d = (
        x[None, :, None] * t0[:, None, :]
        + y[None, :, None] * t1[:, None, :]
        + z[None, :, None] * normal[:, None, :]
    )
    d = d / jnp.linalg.norm(d, axis=2, keepdims=True)

    out_tmax = jnp.where(valid, jnp.asarray(max_dist, jnp.float32), np.float32(-1.0))
    n_out = r * num_samples
    rays = Rays(
        origin=jnp.broadcast_to(origin[:, None, :], (r, num_samples, 3)).reshape(n_out, 3),
        dirn=d.reshape(n_out, 3).astype(jnp.float32),
        tmin=jnp.zeros((n_out,), jnp.float32),
        tmax=jnp.broadcast_to(out_tmax[:, None], (r, num_samples)).reshape(n_out),
    )
    ids = jnp.arange(n_out, dtype=jnp.int32)
    return rays, ids, ids


@partial(jax.jit, static_argnames=("num_samples",))
def gen_shadow_rays(
    in_origin: jnp.ndarray,
    in_dirn: jnp.ndarray,
    in_t: jnp.ndarray,
    in_tri: jnp.ndarray,
    num_samples: int,
    light_position: jnp.ndarray,  # [3]
    light_radius: jnp.ndarray,
    seed: jnp.ndarray,
    task_offset: jnp.ndarray | int = 0,
):
    """Area-light shadow rays (the reference's dormant rayGenShadowKernel,
    RayGenKernels.cu:231-293): Sobol 2D x Hammersley with a per-ray
    Cranley-Patterson random offset toward a spherical light."""
    r = in_origin.shape[0]
    eps = np.float32(1.0e-4)
    origin = in_origin + in_dirn * jnp.maximum(in_t - eps, 0.0)[:, None]
    valid = in_tri >= 0

    task = jnp.arange(r, dtype=jnp.uint32) + jnp.asarray(task_offset, jnp.uint32)
    a = jnp.asarray(seed, jnp.uint32) + task
    b = jnp.full((r,), GOLDEN, jnp.uint32)
    c = jnp.full((r,), GOLDEN, jnp.uint32)
    a, b, c = _jenkins_mix_jnp(a, b, c)
    a, b, c = _jenkins_mix_jnp(a, b, c)
    scale = np.float32(2.0**-32)
    offset = jnp.stack([a.astype(jnp.float32) * scale, b.astype(jnp.float32) * scale, c.astype(jnp.float32) * scale], axis=1)

    # Sobol 2D (reference variant) + Hammersley, host-precomputed per sample.
    from tpu_rt.core.math import sobol2d, hammersley

    sob = jnp.asarray(sobol2d(np.arange(num_samples)), jnp.float32)  # [S,2]
    ham = jnp.asarray(hammersley(np.arange(num_samples), num_samples), jnp.float32)  # [S]
    pos = jnp.concatenate([sob, ham[:, None]], axis=1)  # [S,3]

    p = pos[None, :, :] + offset[:, None, :]  # [R,S,3]
    p = jnp.where(p >= 1.0, p - 1.0, p)
    p = p * 2.0 - 1.0

    target = light_position[None, None, :] + jnp.asarray(light_radius, jnp.float32) * p
    d = target - origin[:, None, :]
    dist = jnp.linalg.norm(d, axis=2)
    dn = d / dist[..., None]

    n_out = r * num_samples
    tmax = jnp.where(valid[:, None], dist, np.float32(-1.0)).reshape(n_out)
    rays = Rays(
        origin=jnp.broadcast_to(origin[:, None, :], (r, num_samples, 3)).reshape(n_out, 3),
        dirn=dn.reshape(n_out, 3).astype(jnp.float32),
        tmin=jnp.zeros((n_out,), jnp.float32),
        tmax=tmax.astype(jnp.float32),
    )
    ids = jnp.arange(n_out, dtype=jnp.int32)
    return rays, ids, ids
