"""RayBuffer: a ray batch + its ID<->slot permutation, with device-side
Morton coherence sorting.

Equivalent of the reference's RayBuffer (src/rt/ray/RayBuffer.hh:37-97):
the permutation decouples the logical ray id (pixel index, or
primary*samples+i) from the memory slot so batches can be Morton-sorted
without losing addressing.  The reference's mortonSort pipeline
(RayBuffer.cc:256-324: device AABB reduction -> device 192-bit key gen ->
HOST qsort -> device reorder) becomes fully device-side here: jnp reductions,
vectorized key interleave, and a lexicographic jax.lax.sort — no host
round-trip.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from tpu_rt.core.types import Hits, Rays


@jax.jit
def ray_morton_keys_device(origin: jnp.ndarray, dirn: jnp.ndarray):
    """[N,6] uint32 Morton keys, the stride-6 interleave of
    genMortonKeysKernel (RayBufferKernels.cu:66-179): origin xyz quantized
    to 24 bits within the batch AABB, normalized direction xyz to 21 bits;
    bit j of stream d -> key bit j*6+d.  Word 5 is most significant."""
    valid = jnp.isfinite(origin).all(axis=1, keepdims=True)
    lo = jnp.min(jnp.where(valid, origin, jnp.inf), axis=0)
    hi = jnp.max(jnp.where(valid, origin, -jnp.inf), axis=0)
    extent = jnp.where(hi - lo > 0, hi - lo, 1.0)
    a = (origin - lo) / extent
    n = dirn / jnp.maximum(jnp.linalg.norm(dirn, axis=1, keepdims=True), 1e-30)
    b = (n + 1.0) * 0.5

    streams = [
        (a[:, 0] * np.float32(256.0 * 65536.0)).astype(jnp.int64).astype(jnp.uint32),
        (a[:, 1] * np.float32(256.0 * 65536.0)).astype(jnp.int64).astype(jnp.uint32),
        (a[:, 2] * np.float32(256.0 * 65536.0)).astype(jnp.int64).astype(jnp.uint32),
        (b[:, 0] * np.float32(32.0 * 65536.0)).astype(jnp.int64).astype(jnp.uint32),
        (b[:, 1] * np.float32(32.0 * 65536.0)).astype(jnp.int64).astype(jnp.uint32),
        (b[:, 2] * np.float32(32.0 * 65536.0)).astype(jnp.int64).astype(jnp.uint32),
    ]
    words = [jnp.zeros(origin.shape[0], jnp.uint32) for _ in range(6)]
    for d, v in enumerate(streams):
        for i in range(32):
            pos = d + i * 6
            if pos >= 192:
                break
            word, bit = pos >> 5, pos & 31
            words[word] = words[word] | (((v >> np.uint32(i)) & np.uint32(1)) << np.uint32(bit))
    return jnp.stack(words, axis=1)


@jax.jit
def morton_sort_device(origin: jnp.ndarray, dirn: jnp.ndarray) -> jnp.ndarray:
    """Permutation sorting rays by 192-bit Morton key, fully on device.
    Key words compare most-significant-first = hash[5]..hash[0]
    (reference compareMortonKey, RayBuffer.cc:237-249)."""
    keys = ray_morton_keys_device(origin, dirn)
    n = origin.shape[0]
    perm = jnp.arange(n, dtype=jnp.int32)
    operands = [keys[:, 5 - k] for k in range(6)] + [perm]
    out = jax.lax.sort(operands, num_keys=6, is_stable=True)
    return out[6]


@jax.jit
def morton_sort_device_coarse(origin: jnp.ndarray,
                              dirn: jnp.ndarray) -> jnp.ndarray:
    """Permutation sorting rays by a 30-bit origin Morton key (10
    bits/axis within the batch AABB) — ONE sort key instead of six.

    Coarse spatial grouping is what ray coherence needs; the fine tail
    of the 192-bit reference key orders rays that are already
    neighbours, and a variadic six-key sort costs several times a
    one-key sort.  ``dirn`` is accepted for signature parity and unused.
    """
    valid = jnp.isfinite(origin).all(axis=1, keepdims=True)
    lo = jnp.min(jnp.where(valid, origin, jnp.inf), axis=0)
    hi = jnp.max(jnp.where(valid, origin, -jnp.inf), axis=0)
    extent = jnp.where(hi - lo > 0, hi - lo, 1.0)
    q = ((origin - lo) / extent * np.float32(1023.0)).astype(
        jnp.int32).clip(0, 1023).astype(jnp.uint32)
    key = jnp.zeros(origin.shape[0], jnp.uint32)
    for i in range(10):
        for d in range(3):
            key = key | (((q[:, d] >> np.uint32(i)) & np.uint32(1))
                         << np.uint32(i * 3 + d))
    n = origin.shape[0]
    perm = jnp.arange(n, dtype=jnp.int32)
    return jax.lax.sort([key, perm], num_keys=1, is_stable=True)[1]


@jax.jit
def sort_dead_last_device(rays: Rays) -> jnp.ndarray:
    """Morton permutation with the degenerate flag (tmax<0) as the most
    significant key: live rays first in Morton order, dead rays last.

    This is a batch-level analogue of the reference's dynamic ray fetch
    (kepler_dynamic_fetch.cu:48,398-401): instead of lanes refilling
    from a work queue, dead work is compacted out of the traced prefix
    (pair with trace_live_prefix).  It pays where dead slots cost work,
    as in the XLA wavefront tracer, whose while_loop runs until the LAST
    lane finishes; the CUDA kernel retires dead rays at fetch.
    """
    keys = ray_morton_keys_device(rays.origin, rays.dirn)
    dead = (rays.tmax < 0).astype(jnp.uint32)
    n = rays.origin.shape[0]
    perm = jnp.arange(n, dtype=jnp.int32)
    operands = [dead] + [keys[:, 5 - k] for k in range(6)] + [perm]
    return jax.lax.sort(operands, num_keys=7, is_stable=True)[7]


LIVE_BUCKETS = 8


def live_prefix_len(live: int, n: int) -> int:
    """Rays traced for `live` live rays at the head of an n-ray batch:
    `live` rounded up to a multiple of ceil(n / LIVE_BUCKETS), at most n.

    Each distinct length compiles the tracer once, so the bucket bounds
    the compiles per batch size at LIVE_BUCKETS, at the cost of tracing
    at most n / LIVE_BUCKETS dead rays."""
    step = max(1, -(-n // LIVE_BUCKETS))
    return min(n, -(-max(int(live), 0) // step) * step)


def trace_live_prefix(trace_fn, rays: Rays, live: int) -> Hits:
    """Trace only the first live_prefix_len(live, N) rays of a
    dead-last-sorted batch; dead suffix results are misses by
    construction (tri=-1, t=tmax), exactly what a tracer emits for
    tmax<0 rays.

    trace_fn: rays -> Hits.  live: number of tmax>=0 rays (host
    scalar — the frame path already knows it: primary hits x samples,
    Renderer.cc:221-238)."""
    n = int(rays.origin.shape[0])
    m = live_prefix_len(live, n)
    if m >= n:
        return trace_fn(rays)
    sub = jax.tree_util.tree_map(lambda x: x[:m], rays)
    h = trace_fn(sub)
    fill = n - m
    return Hits(
        tri=jnp.concatenate([h.tri, jnp.full((fill,), -1, jnp.int32)]),
        t=jnp.concatenate([h.t, rays.tmax[m:]]),
        u=jnp.concatenate([h.u, jnp.zeros((fill,), jnp.float32)]),
        v=jnp.concatenate([h.v, jnp.zeros((fill,), jnp.float32)]),
    )


class RayBuffer:
    """Host-side handle bundling rays, results, and the ID<->slot maps."""

    def __init__(self, rays: Rays, slot_to_id=None, id_to_slot=None, need_closest_hit: bool = True):
        n = int(rays.origin.shape[0])
        ident = np.arange(n, dtype=np.int32)
        self.rays = rays
        self.slot_to_id = np.asarray(slot_to_id if slot_to_id is not None else ident, np.int32)
        self.id_to_slot = np.asarray(id_to_slot if id_to_slot is not None else ident, np.int32)
        self.need_closest_hit = need_closest_hit
        self.hits: Hits | None = None

    @property
    def size(self) -> int:
        return int(self.rays.origin.shape[0])

    def get_ray_for_id(self, ray_id: int):
        slot = int(self.id_to_slot[ray_id])
        return (
            np.asarray(self.rays.origin)[slot],
            np.asarray(self.rays.dirn)[slot],
            float(np.asarray(self.rays.tmin)[slot]),
            float(np.asarray(self.rays.tmax)[slot]),
        )

    def get_result_for_id(self, ray_id: int):
        assert self.hits is not None
        slot = int(self.id_to_slot[ray_id])
        return int(np.asarray(self.hits.tri)[slot]), float(np.asarray(self.hits.t)[slot])

    def morton_sort(self) -> None:
        """Reorder rays by Morton key, updating both permutation maps
        (device sort; reference semantics RayBuffer.cc:256-324)."""
        order = np.asarray(morton_sort_device(self.rays.origin, self.rays.dirn))
        inv = np.empty_like(order)
        inv[order] = np.arange(order.size, dtype=order.dtype)
        self.rays = Rays(
            origin=self.rays.origin[order],
            dirn=self.rays.dirn[order],
            tmin=self.rays.tmin[order],
            tmax=self.rays.tmax[order],
        )
        self.slot_to_id = self.slot_to_id[order]
        self.id_to_slot = inv[self.id_to_slot]
        self.hits = None  # results are slot-addressed; invalidated by reorder
