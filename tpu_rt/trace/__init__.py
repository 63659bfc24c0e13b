from tpu_rt.trace.cpu_reference import (
    RayStats,
    assign_treelets,
    intersect_brute,
    trace_flat_scalar,
)
from tpu_rt.trace.xla_tracer import trace_wavefront, device_bvh

__all__ = [
    "RayStats",
    "assign_treelets",
    "intersect_brute",
    "trace_flat_scalar",
    "trace_wavefront",
    "device_bvh",
    "make_routing_tracer",
    "TRACERS",
]

TRACERS = ("auto", "cuda", "xla")


def _xla_routing(tables, rays, any_hit=False):
    return trace_wavefront(tables, rays, any_hit=any_hit)


def make_routing_tracer(flat, prefer: str = "auto"):
    """Resolve the device tracer for the current backend.

    Returns (fn, kind, tables): fn(tables, rays, any_hit) -> Hits is
    jittable and shard_map-safe, kind is "cuda" or "xla", and tables is
    the device FlatBVH to pass (replicate it for a mesh).  fn is hashable
    and equal across calls with the same configuration, so it can be a
    static jit argument.

    prefer:
      "auto" — "cuda" when JAX runs on a GPU, "xla" otherwise;
      "cuda" — the CUDA traversal kernel; raises RuntimeError without a
               GPU or when the kernel does not build;
      "xla"  — the plain wavefront tracer (the reference the kernel is
               checked against).
    """
    import jax

    if prefer not in TRACERS:
        raise ValueError(f"tracer must be one of {TRACERS}, got {prefer!r}")
    if prefer == "auto":
        prefer = "cuda" if jax.default_backend() == "gpu" else "xla"
    if prefer == "cuda":
        from tpu_rt.trace.cuda_tracer import cuda_routing

        fn = cuda_routing()
        return fn, "cuda", device_bvh(flat)
    return _xla_routing, "xla", device_bvh(flat)
