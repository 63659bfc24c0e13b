"""tpu_rt — a differentiable wavefront ray-tracing framework in JAX.

A JAX/XLA re-design of the capabilities of the reference CUDA framework (yanrun000/gpu-ray-tracing, the Aila-Laine HPG2009 wavefront
tracer): OBJ/MTL scene loading, host SBVH construction with a hash-keyed build
cache, a flat Compact2-style BVH with Woop-transformed triangles, primary/AO/
diffuse ray generation with Morton-order coherence scheduling, a vectorized
BVH-traversal kernel for the GPU (CUDA through jax.ffi) beside a plain XLA
wavefront tracer, shading/image reconstruction — extended with end-to-end
differentiability and multi-card scaling via jax.sharding.

Layer map (mirrors SURVEY.md section 1):

    core/    scalar types, SoA pytrees (Rays, Hits), math + hashing utilities
    scene/   OBJ+MTL import, Scene flattening, camera (+ signature codec),
             Morton pixel table, procedural test scenes
    bvh/     SBVH builder (host), flatten to Compact2-style arrays + Woop
             transform, hash-keyed build cache
    trace/   CPU oracle tracer, XLA wavefront tracer, CUDA traversal kernel,
             oracle adjudication
    raygen/  primary / AO / diffuse / shadow generators, batching
    shade/   image reconstruction, differentiable shading
    dist/    device-mesh sharding of the ray batch, gradient reductions
    bench/   CLI + Mray/s harness, device checks
"""

__version__ = "0.1.0"
