"""Vectorized wavefront BVH traversal in pure JAX/XLA — the plain
reference tracer (runs wherever XLA does) that the CUDA kernel is checked
against on the card.

A batch-wide rewrite of the reference's persistent-threads kernel
(src/rt/kernels/kepler_dynamic_fetch.cu:66-411; SURVEY.md section 2.3):

- one ray per SIMT lane              -> one ray per array element over the
                                        whole batch
- while-while + postponed leaf       -> each wavefront step advances every
                                        lane by one unit of work: lanes
                                        holding a leaf test ONE Woop triangle,
                                        other lanes do one node step (slab
                                        tests of both children, near-first,
                                        push far).  "ballot" disappears: phase
                                        membership is just a lane mask.
- per-thread stack in local memory   -> [N, DEPTH] i32 stack in device memory
                                        with per-lane scatter/gather of the top
- dynamic ray fetch / warp compaction-> none: the batch while_loop runs until
                                        its slowest ray finishes
- tex1Dfetch node/tri loads          -> row gathers from the device tables

Arithmetic parity: ooeps = 2^-80 idir clamp (kernel :134-140), span tests as
max-of-mins/min-of-maxes vs tmin/current-hitT (:247-279 spanBegin/EndKepler),
Woop leaf test with the GPU sign convention (:334-370) in the oracle's
operation order, strict t bounds, anyHit early-out (:376-381), degenerate
rays tmax<0 never traced.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from tpu_rt.core.types import FlatBVH, Hits, Rays, SENTINEL

STACK_DEPTH = 64  # reference STACK_SIZE (kepler_dynamic_fetch.cu:47)
OOEPS = np.float32(2.0**-80)


def device_bvh(flat: FlatBVH) -> FlatBVH:
    """Upload a host FlatBVH to device arrays (idempotent)."""
    return FlatBVH(
        nodes=jnp.asarray(np.asarray(flat.nodes), jnp.float32),
        tri_woop=jnp.asarray(np.asarray(flat.tri_woop), jnp.float32),
        tri_index=jnp.asarray(np.asarray(flat.tri_index), jnp.int32),
        leaf_counts=jnp.asarray(np.asarray(flat.leaf_counts), jnp.int32),
    )


def _ray_setup(rays: Rays):
    d = rays.dirn
    safe = jnp.where(jnp.abs(d) > OOEPS, d, jnp.copysign(OOEPS, d))
    idir = 1.0 / safe
    ood = rays.origin * idir
    return idir, ood


def woop_tuv(w, origin, dirn):
    """(t, u, v) of rays against Woop rows w [n,12], in the oracle's
    operation order (cpu_reference.trace_flat_scalar, reference kernel
    :334-370): every product and sum rounds in turn, and t = Oz * (1/Dz).
    Written elementwise, so no matrix unit (and no TF32) is involved."""
    o0, o1, o2 = origin[:, 0], origin[:, 1], origin[:, 2]
    d0, d1, d2 = dirn[:, 0], dirn[:, 1], dirn[:, 2]
    oz = w[:, 3] - o0 * w[:, 0] - o1 * w[:, 1] - o2 * w[:, 2]
    dz = d0 * w[:, 0] + d1 * w[:, 1] + d2 * w[:, 2]
    t = oz * (1.0 / dz)
    ox = w[:, 7] + o0 * w[:, 4] + o1 * w[:, 5] + o2 * w[:, 6]
    dx = d0 * w[:, 4] + d1 * w[:, 5] + d2 * w[:, 6]
    oy = w[:, 11] + o0 * w[:, 8] + o1 * w[:, 9] + o2 * w[:, 10]
    dy = d0 * w[:, 8] + d1 * w[:, 9] + d2 * w[:, 10]
    return t, ox + t * dx, oy + t * dy


@partial(jax.jit, static_argnames=("any_hit", "with_stats"))
def trace_wavefront(flat: FlatBVH, rays: Rays, any_hit: bool = False, with_stats: bool = False):
    """Trace a ray batch against the BVH.  Returns Hits (hit ids are original
    scene triangle indices, -1 for miss) and, if with_stats, a dict of
    per-ray node/triangle test counters."""
    nodes = flat.nodes
    links = jax.lax.bitcast_convert_type(nodes[:, 12:16], jnp.int32)  # [N,4]
    woop = flat.tri_woop
    tri_index = flat.tri_index
    leaf_counts = flat.leaf_counts

    n = rays.origin.shape[0]
    num_refs = woop.shape[0]
    idir, ood = _ray_setup(rays)
    origin, dirn = rays.origin, rays.dirn
    tmin = rays.tmin

    sent = jnp.int32(SENTINEL)

    if num_refs == 0 or nodes.shape[0] == 0:
        zeros = jnp.zeros((n,), jnp.float32)
        hits = Hits(tri=jnp.full((n,), -1, jnp.int32), t=rays.tmax, u=zeros, v=zeros)
        if with_stats:
            zi = jnp.zeros((n,), jnp.int32)
            return hits, {"node_tests": zi, "tri_tests": zi}
        return hits

    # State tuple.
    node = jnp.where(rays.tmax < 0.0, sent, jnp.int32(0))
    leaf_ptr = jnp.full((n,), -1, jnp.int32)   # >=0: next woop row to test
    leaf_end = jnp.zeros((n,), jnp.int32)
    stack = jnp.full((n, STACK_DEPTH), SENTINEL, jnp.int32)
    sp = jnp.zeros((n,), jnp.int32)
    hit_row = jnp.full((n,), -1, jnp.int32)
    hit_t = rays.tmax
    hit_u = jnp.zeros((n,), jnp.float32)
    hit_v = jnp.zeros((n,), jnp.float32)
    node_tests = jnp.zeros((n,), jnp.int32)
    tri_tests = jnp.zeros((n,), jnp.int32)

    rows_idx = jnp.arange(n, dtype=jnp.int32)

    def cond(state):
        node, leaf_ptr, *_ = state
        return jnp.any((node != sent) | (leaf_ptr >= 0))

    def body(state):
        node, leaf_ptr, leaf_end, stack, sp, hit_row, hit_t, hit_u, hit_v, node_tests, tri_tests = state

        # ---------------- leaf phase: one Woop triangle per lane ------------
        in_leaf = leaf_ptr >= 0
        trow = jnp.where(in_leaf, leaf_ptr, 0)
        t, u, v = woop_tuv(woop[trow], origin, dirn)  # [n,12] gather
        accept = in_leaf & (t > tmin) & (t < hit_t) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)

        hit_t = jnp.where(accept, t, hit_t)
        hit_row = jnp.where(accept, trow, hit_row)
        hit_u = jnp.where(accept, u, hit_u)
        hit_v = jnp.where(accept, v, hit_v)
        tri_tests = tri_tests + in_leaf.astype(jnp.int32)

        leaf_ptr = jnp.where(in_leaf, leaf_ptr + 1, leaf_ptr)
        leaf_done = in_leaf & (leaf_ptr >= leaf_end)
        leaf_ptr = jnp.where(leaf_done, -1, leaf_ptr)
        if any_hit:
            # First accepted hit retires the lane (kernel :376-381).
            node = jnp.where(accept, sent, node)
            leaf_ptr = jnp.where(accept, -1, leaf_ptr)

        # ---------------- node phase: one traversal step --------------------
        # A lane can arrive here with a *leaf link* in its node register
        # (popped off the stack last step); it passes through the slab logic
        # untouched and is converted to leaf registers below.
        in_node = (~in_leaf) & (node != sent)
        is_inner = in_node & (node >= 0)
        nrow = jnp.where(is_inner, node, 0)
        nd = nodes[nrow]  # [n,16] gather
        lk = links[nrow]  # [n,4]
        node_tests = node_tests + is_inner.astype(jnp.int32)

        def slab(lo_cols, hi_cols):
            lo_t = nd[:, lo_cols] * idir - ood  # [n,3]
            hi_t = nd[:, hi_cols] * idir - ood
            near = jnp.maximum(jnp.max(jnp.minimum(lo_t, hi_t), axis=1), tmin)
            far = jnp.minimum(jnp.min(jnp.maximum(lo_t, hi_t), axis=1), hit_t)
            return near, far

        c0min, c0max = slab((0, 2, 8), (1, 3, 9))
        c1min, c1max = slab((4, 6, 10), (5, 7, 11))
        hit0 = c0max >= c0min
        hit1 = c1max >= c1min
        c0, c1 = lk[:, 0], lk[:, 1]

        both = hit0 & hit1
        swap = both & (c1min < c0min)
        near_child = jnp.where(swap, c1, jnp.where(hit0, c0, c1))
        far_child = jnp.where(swap, c0, c1)

        # Push far child where both children hit.
        push = is_inner & both
        sp_clamped = jnp.clip(sp, 0, STACK_DEPTH - 1)
        cur_top = stack[rows_idx, sp_clamped]
        stack = stack.at[rows_idx, sp_clamped].set(jnp.where(push, far_child, cur_top))
        sp = sp + push.astype(jnp.int32)

        # Pop where neither hit.
        miss = is_inner & ~hit0 & ~hit1
        new_node = jnp.where(is_inner, jnp.where(miss, jnp.int32(0), near_child), node)

        def pop(node_val, stack, sp, want):
            sp_next = jnp.where(want, sp - 1, sp)
            sp_read = jnp.clip(sp_next, 0, STACK_DEPTH - 1)
            popped = stack[rows_idx, sp_read]
            popped = jnp.where(sp_next < 0, sent, popped)
            return jnp.where(want, popped, node_val), sp_next

        new_node, sp = pop(new_node, stack, sp, miss)
        # (lanes that entered with a leaf link keep it: new_node == node < 0)

        # Leaf child reached: move it to the leaf registers and pop the next
        # traversal node (kernel :289-296 postpone logic — with the phase
        # interleave there is no "postpone max 1" limit to emulate).
        is_leaf_child = in_node & (new_node < 0)
        first = jnp.where(is_leaf_child, ~new_node, 0)
        first_c = jnp.clip(first, 0, num_refs)
        count = leaf_counts[first_c]
        leaf_ptr = jnp.where(is_leaf_child, first_c, leaf_ptr)
        leaf_end = jnp.where(is_leaf_child, first_c + count, leaf_end)
        # Empty leaves retire immediately.
        leaf_ptr = jnp.where(is_leaf_child & (count == 0), -1, leaf_ptr)

        new_node2, sp = pop(new_node, stack, sp, is_leaf_child)
        node = jnp.where(in_node, new_node2, node)

        return node, leaf_ptr, leaf_end, stack, sp, hit_row, hit_t, hit_u, hit_v, node_tests, tri_tests

    state = (node, leaf_ptr, leaf_end, stack, sp, hit_row, hit_t, hit_u, hit_v, node_tests, tri_tests)
    state = jax.lax.while_loop(cond, body, state)
    node, leaf_ptr, leaf_end, stack, sp, hit_row, hit_t, hit_u, hit_v, node_tests, tri_tests = state

    tri = jnp.where(
        hit_row >= 0,
        tri_index[jnp.clip(hit_row, 0, max(0, num_refs - 1))],
        jnp.int32(-1),
    )
    hits = Hits(tri=tri, t=hit_t, u=hit_u, v=hit_v)
    if with_stats:
        return hits, {"node_tests": node_tests, "tri_tests": tri_tests}
    return hits
