"""Check a device tracer against the plain reference, with the scalar CPU
oracle as judge.

A tracer under test and trace_wavefront trace the same rays on the same
device.  Every ray on which they disagree is traced again by
trace_flat_scalar, and the tracer's answer is classified against it:

- closest hit: ``exact`` (same triangle id), ``tie`` (another triangle at
  the same distance, t within rtol 2e-4 / atol 1e-5) or ``graze`` (the
  oracle's hit lies within a barycentric margin of 1e-3 of an edge);
  anything else is ``wrong``;
- any hit: only hit/miss is compared, since any occluder will do.

The tolerances reflect float32 arithmetic compiled by different
toolchains.  The oracle rounds every operation; the CUDA kernel is
compiled without FMA contraction to do the same, in the same order; XLA
fuses as it chooses.  Near-equal distances and rays through an edge can
therefore resolve differently between the device tracers.
"""

from __future__ import annotations

import numpy as np

TIE_RTOL = 2e-4
TIE_ATOL = 1e-5
GRAZE_MARGIN = 1e-3
# Agreement of t between two device tracers before a ray counts as
# disputed (closest hit).
T_RTOL = 1e-4
T_ATOL = 1e-6


def disputed(got_tri, got_t, want_tri, want_t, any_hit: bool) -> np.ndarray:
    """Boolean mask of rays on which two tracers disagree."""
    got_tri, want_tri = np.asarray(got_tri), np.asarray(want_tri)
    if any_hit:
        return (got_tri >= 0) != (want_tri >= 0)
    bad = got_tri != want_tri
    bad |= (got_tri >= 0) & ~np.isclose(np.asarray(got_t), np.asarray(want_t),
                                         rtol=T_RTOL, atol=T_ATOL)
    return bad


def adjudicate(got_tri, got_t, oracle, any_hit: bool) -> dict:
    """Classify a tracer's answers against the oracle's
    (id, t, u, v) for the same rays.  Returns boolean masks
    {"exact", "tie", "graze", "wrong"}; the four are disjoint."""
    got_tri, got_t = np.asarray(got_tri), np.asarray(got_t)
    s_id, s_t, s_u, s_v = (np.asarray(a) for a in oracle)
    if any_hit:
        exact = (got_tri >= 0) == (s_id >= 0)
        none = np.zeros_like(exact)
        return {"exact": exact, "tie": none, "graze": none.copy(),
                "wrong": ~exact}
    exact = got_tri == s_id
    tie = ~exact & np.isclose(got_t, s_t, rtol=TIE_RTOL, atol=TIE_ATOL)
    margin = np.minimum(np.minimum(s_u, s_v), 1.0 - s_u - s_v)
    graze = ~exact & ~tie & (s_id >= 0) & (margin < GRAZE_MARGIN)
    return {"exact": exact, "tie": tie, "graze": graze,
            "wrong": ~exact & ~tie & ~graze}


def compare_hits(flat, rays, got, want, any_hit: bool) -> dict:
    """Adjudicate `got` (Hits of the tracer under test) against `want`
    (Hits of the reference) on `rays`.  Returns counts: rays, disputed,
    tie, graze, wrong, and the first wrong rays with the (id, t) each
    tracer and the oracle gave."""
    from tpu_rt.trace.cpu_reference import trace_flat_scalar

    got_tri, got_t = np.asarray(got.tri), np.asarray(got.t)
    bad = disputed(got_tri, got_t, want.tri, want.t, any_hit)
    idx = np.nonzero(bad)[0]
    report = {"rays": int(got_tri.size), "disputed": int(idx.size), "tie": 0,
              "graze": 0, "wrong": 0, "first_wrong": []}
    if idx.size == 0:
        return report
    oracle = trace_flat_scalar(
        flat, np.asarray(rays.origin)[idx], np.asarray(rays.dirn)[idx],
        np.asarray(rays.tmin)[idx], np.asarray(rays.tmax)[idx],
        any_hit=any_hit)
    v = adjudicate(got_tri[idx], got_t[idx], oracle, any_hit)
    w = np.nonzero(v["wrong"])[0][:8]
    report.update(
        tie=int(v["tie"].sum()), graze=int(v["graze"].sum()),
        wrong=int(v["wrong"].sum()), first_wrong=[
            {"ray": int(idx[k]), "got": (int(got_tri[idx[k]]), float(got_t[idx[k]])),
             "reference": (int(np.asarray(want.tri)[idx[k]]),
                           float(np.asarray(want.t)[idx[k]])),
             "oracle": (int(oracle[0][k]), float(oracle[1][k]))}
            for k in w])
    return report


def verify_on_device(flat, dbvh, rays, any_hit: bool, trace_fn,
                     n_check: int | None = None) -> dict:
    """Trace a subset of `rays` (every k-th, about n_check of them; all if
    None) with trace_fn(rays, any_hit) and with trace_wavefront over the
    device BVH `dbvh`, and adjudicate with the oracle over the host
    `flat`.  Returns compare_hits' report."""
    from tpu_rt.core.types import Rays
    from tpu_rt.trace.xla_tracer import trace_wavefront

    n = int(rays.origin.shape[0])
    step = 1 if n_check is None else max(1, n // n_check)
    sub = Rays(origin=rays.origin[::step], dirn=rays.dirn[::step],
               tmin=rays.tmin[::step], tmax=rays.tmax[::step])
    got = trace_fn(sub, any_hit)
    want = trace_wavefront(dbvh, sub, any_hit=any_hit)
    return compare_hits(flat, sub, got, want, any_hit)
