"""Core data types: SoA pytrees for rays, hits, and the flattened BVH.

Design notes
------------
The reference keeps rays as an AoS of 32-byte structs and the BVH as raw byte
buffers with float4 texture fetches (src/rt/Util.hh:64-89,
src/rt/cuda/CudaBVH.hh:40-83 in the reference).  Here rays are
structure-of-arrays with static shapes, which XLA fuses well, and the BVH
uses integer *row indices* instead of byte offsets so node/triangle fetches
are plain gathers (the CUDA kernel packs rays back into two float4 per ray
and reads the same rows as float4).

- ``Rays``   : origins/directions as [N,3] f32, tmin/tmax as [N] f32.
- ``Hits``   : hit triangle id ([N] i32, -1 = miss) and hit distance t.
- ``FlatBVH``: the Compact2-equivalent layout (reference
  src/rt/cuda/CudaBVH.cc:270-357).  One 16-float row per inner node holding
  both children's slabs plus the two child links; Woop triangles as [M,12]
  rows; a [M] remap to original triangle ids.  Child links are row indices;
  a negative link ``c`` means "leaf", whose triangle rows are
  ``[~c, ~c + count)`` — the count is stored explicitly instead of the
  reference's -0.0f terminator sentinel, so leaf loops are counted.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax.numpy as jnp

# Sentinel node "address" marking an empty traversal stack / retired lane.
# The reference uses 0x76543210 (EntrypointSentinel,
# src/rt/kernels/CudaTracerKernels.hh:107).  We use INT32_MAX so that the
# "is leaf" test stays a simple sign test.
SENTINEL = np.int32(0x7FFFFFFF)


class Rays(NamedTuple):
    """A batch of rays, SoA.  All arrays share the leading dim N."""

    origin: jnp.ndarray  # [N, 3] f32
    dirn: jnp.ndarray    # [N, 3] f32
    tmin: jnp.ndarray    # [N]    f32
    tmax: jnp.ndarray    # [N]    f32  (< 0 marks a degenerate/disabled ray)

    @property
    def num(self) -> int:
        return int(self.origin.shape[0])


class Hits(NamedTuple):
    """Trace results.  ``tri`` is the *original* scene triangle id (-1 miss).

    Equivalent of the reference's RayResult {id, t} (src/rt/Util.hh:79-89).
    ``u``/``v`` are the barycentric coordinates at the hit (0 where miss);
    the reference discards them but they are the differentiable quantities.
    """

    tri: jnp.ndarray  # [N] i32
    t: jnp.ndarray    # [N] f32
    u: jnp.ndarray    # [N] f32
    v: jnp.ndarray    # [N] f32


class FlatBVH(NamedTuple):
    """Flattened two-wide BVH in the Compact2-equivalent layout.

    nodes: [num_nodes, 16] f32.  Per row (matching the reference float4x4
    semantic, src/rt/cuda/CudaBVH.cc:333-337, but index- not byte-addressed):

        cols  0: 3  c0.lo.x, c0.hi.x, c0.lo.y, c0.hi.y
        cols  4: 7  c1.lo.x, c1.hi.x, c1.lo.y, c1.hi.y
        cols  8:11  c0.lo.z, c0.hi.z, c1.lo.z, c1.hi.z
        cols 12:13  child links (bitcast i32): >=0 inner row; <0 leaf, first
                    woop row = ~link
        cols 14:15  leaf triangle counts for child0/child1 (bitcast i32;
                    0 for inner children)

    tri_woop : [num_refs, 12] f32 — Woop rows (woopZ, woopU, woopV), each 4
               floats, per *reference* (SBVH may duplicate triangles).
    tri_index: [num_refs] i32 — original scene triangle index per woop row.
    leaf_counts: [num_refs + 1] i32 — triangle count of the leaf starting at
               each woop row (0 elsewhere).  This replaces the reference's
               -0.0f terminator: a popped leaf link ~first recovers its
               extent as ``leaf_counts[first]`` with one gather, keeping the
               triangle loop counted.  Row num_refs is the empty leaf.
    """

    nodes: jnp.ndarray       # [num_nodes, 16] f32 (cols 12..15 bitcast i32)
    tri_woop: jnp.ndarray    # [num_refs, 12] f32
    tri_index: jnp.ndarray   # [num_refs] i32
    leaf_counts: jnp.ndarray # [num_refs + 1] i32

    @property
    def num_nodes(self) -> int:
        return int(self.nodes.shape[0])

    @property
    def num_refs(self) -> int:
        return int(self.tri_woop.shape[0])


class AABB:
    """Host-side axis-aligned bounding box (numpy).  Mirrors the semantics of
    the reference's FW::AABB (src/rt/Util.hh:37-60): starts inverted so that
    ``valid()`` is false until grown."""

    __slots__ = ("lo", "hi")

    def __init__(self, lo=None, hi=None):
        self.lo = np.full(3, np.inf, np.float32) if lo is None else np.asarray(lo, np.float32).copy()
        self.hi = np.full(3, -np.inf, np.float32) if hi is None else np.asarray(hi, np.float32).copy()

    def grow_point(self, p) -> "AABB":
        np.minimum(self.lo, p, out=self.lo)
        np.maximum(self.hi, p, out=self.hi)
        return self

    def grow(self, other: "AABB") -> "AABB":
        np.minimum(self.lo, other.lo, out=self.lo)
        np.maximum(self.hi, other.hi, out=self.hi)
        return self

    def intersect(self, other: "AABB") -> "AABB":
        np.maximum(self.lo, other.lo, out=self.lo)
        np.minimum(self.hi, other.hi, out=self.hi)
        return self

    def valid(self) -> bool:
        return bool(np.all(self.lo <= self.hi))

    def area(self) -> float:
        """Total surface area; 0 for an invalid box (reference Util.hh:52-56)."""
        if not self.valid():
            return 0.0
        d = self.hi - self.lo
        return float(2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]))

    def midpoint(self):
        return (self.lo + self.hi) * 0.5

    def copy(self) -> "AABB":
        return AABB(self.lo, self.hi)

    def __repr__(self):
        return f"AABB(lo={self.lo.tolist()}, hi={self.hi.tolist()})"


def make_rays(origin, dirn, tmin, tmax) -> Rays:
    """Build a Rays batch from array-likes, casting to the canonical dtypes."""
    return Rays(
        origin=jnp.asarray(origin, jnp.float32).reshape(-1, 3),
        dirn=jnp.asarray(dirn, jnp.float32).reshape(-1, 3),
        tmin=jnp.asarray(tmin, jnp.float32).reshape(-1),
        tmax=jnp.asarray(tmax, jnp.float32).reshape(-1),
    )


def concat_rays(a: Rays, b: Rays) -> Rays:
    return Rays(
        origin=jnp.concatenate([a.origin, b.origin]),
        dirn=jnp.concatenate([a.dirn, b.dirn]),
        tmin=jnp.concatenate([a.tmin, b.tmin]),
        tmax=jnp.concatenate([a.tmax, b.tmax]),
    )


def pad_rays(rays: Rays, multiple: int) -> tuple[Rays, int]:
    """Pad the batch up to a multiple (e.g. the mesh size for sharding).

    Padding rays get tmax = -1, the reference's "degenerate ray" convention
    (src/rt/ray/RayGenKernels.cu:221) so tracers skip them.  Returns the
    padded batch and the original size.
    """
    n = rays.origin.shape[0]
    target = -(-n // multiple) * multiple
    pad = target - n
    if pad == 0:
        return rays, n
    padded = Rays(
        origin=jnp.concatenate([rays.origin, jnp.zeros((pad, 3), jnp.float32)]),
        dirn=jnp.concatenate([rays.dirn, jnp.tile(jnp.asarray([[1.0, 0.0, 0.0]], jnp.float32), (pad, 1))]),
        tmin=jnp.concatenate([rays.tmin, jnp.zeros((pad,), jnp.float32)]),
        tmax=jnp.concatenate([rays.tmax, jnp.full((pad,), -1.0, jnp.float32)]),
    )
    return padded, n
