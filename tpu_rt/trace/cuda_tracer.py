"""The CUDA traversal kernel (trace/cuda/traverse.cu) as a JAX operation.

The kernel is compiled with nvcc for sm_90a on first use (tpu_rt._build),
registered as an XLA FFI target, and called with jax.ffi.ffi_call.  It has
no interpret mode: on a machine without a GPU, building or selecting it
raises.  Everything around the call (ray packing, result unpacking, launch
sizing, the hashable routing callable) is plain Python and numpy, tested on
the CPU; the kernel's arithmetic is the plain reference's
(trace_wavefront), against which it is checked on the card.

Results follow the reference kernel's int2 RayResult: the original
triangle id and the hit distance.  Barycentrics are not returned (u = v =
0); the differentiable path recomputes them from raw vertices.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
import time
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from tpu_rt import _build
from tpu_rt.core.types import FlatBVH, Hits, Rays

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda", "traverse.cu")
TARGET = "tpu_rt_trace"
BLOCK_THREADS = 128  # kBlockThreads in traverse.cu

_lock = threading.Lock()
_state: dict = {}


def nvcc_path() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return default if os.path.exists(default) else None


def nvcc_command(nvcc: str) -> list[str]:
    """The compile command, with "{out}" for the output path."""
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
            "-I", jax.ffi.include_dir(), "-o", "{out}", SRC]


def pack_rays(rays: Rays) -> jnp.ndarray:
    """[N, 8] f32 rows of two float4: (origin, tmin), (dir, tmax)."""
    return jnp.concatenate(
        [rays.origin, rays.tmin[:, None], rays.dirn, rays.tmax[:, None]],
        axis=1).astype(jnp.float32)


def unpack_results(out: jnp.ndarray) -> Hits:
    """[N, 2] i32 (triangle id, t bits) -> Hits with u = v = 0."""
    tri = out[:, 0]
    t = jax.lax.bitcast_convert_type(out[:, 1], jnp.float32)
    zeros = jnp.zeros_like(t)
    return Hits(tri=tri, t=t, u=zeros, v=zeros)


def launch_grid(num_rays: int, sm_count: int, blocks_per_sm: int,
                block_threads: int = BLOCK_THREADS) -> int:
    """Blocks of the persistent grid: every SM filled to the kernel's
    occupancy, but no more blocks than one ray per thread needs."""
    if num_rays <= 0:
        return 0
    resident = max(1, sm_count) * max(1, blocks_per_sm)
    return max(1, min(resident, -(-num_rays // block_threads)))


def _misses(rays: Rays) -> Hits:
    zeros = jnp.zeros_like(rays.tmax)
    return Hits(tri=jnp.full(rays.tmax.shape, -1, jnp.int32), t=rays.tmax,
                u=zeros, v=zeros)


@partial(jax.jit, static_argnames=("any_hit", "grid"))
def trace_cuda(flat: FlatBVH, rays: Rays, any_hit: bool, grid: int) -> Hits:
    """Trace `rays` with the CUDA kernel on a persistent grid of `grid`
    blocks (see launch_grid).  `flat` holds device arrays."""
    n = rays.origin.shape[0]
    if n == 0 or flat.nodes.shape[0] == 0 or flat.tri_woop.shape[0] == 0:
        return _misses(rays)
    out, _counter = jax.ffi.ffi_call(
        TARGET,
        (jax.ShapeDtypeStruct((n, 2), jnp.int32),
         jax.ShapeDtypeStruct((1,), jnp.uint32)),
    )(pack_rays(rays), flat.nodes, flat.tri_woop, flat.tri_index,
      flat.leaf_counts, any_hit=np.int32(any_hit), grid=np.int32(grid))
    return unpack_results(out)


class CudaRouting:
    """Hashable routing callable for the CUDA kernel.

    Downstream code passes the routing function as a static jit argument
    (dist/sharding.py), where equality and hash decide cache hits; this
    callable compares by its launch configuration, so re-creating it does
    not recompile."""

    def __init__(self, sm_count: int, blocks_per_sm: int):
        self._cfg = (int(sm_count), int(blocks_per_sm))

    def __call__(self, tables: FlatBVH, rays: Rays, any_hit: bool = False) -> Hits:
        grid = launch_grid(int(rays.origin.shape[0]), *self._cfg)
        return trace_cuda(tables, rays, any_hit=bool(any_hit), grid=grid)

    def __eq__(self, other):
        return type(other) is CudaRouting and self._cfg == other._cfg

    def __hash__(self):
        return hash(self._cfg)


def load_kernel() -> dict:
    """Build (once), load and register the kernel; returns
    {"lib", "build_s", "sm_count", "blocks_per_sm"}.  Raises RuntimeError
    when there is no GPU backend or the build fails."""
    with _lock:
        if _state:
            return dict(_state)
        if jax.default_backend() != "gpu":
            raise RuntimeError(
                "the CUDA tracer needs a GPU backend; JAX is on "
                f"{jax.default_backend()!r}")
        nvcc = nvcc_path()
        if nvcc is None:
            raise RuntimeError("the CUDA tracer needs nvcc (CUDA toolkit)")
        t0 = time.perf_counter()
        path = _build.build_library("libtpurt_trace", SRC, nvcc_command(nvcc))
        build_s = time.perf_counter() - t0
        lib = ctypes.CDLL(path)
        lib.tpu_rt_trace_occupancy.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.tpu_rt_trace_occupancy.restype = ctypes.c_int
        lib.tpu_rt_trace_block_threads.argtypes = []
        lib.tpu_rt_trace_block_threads.restype = ctypes.c_int
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.TpuRtTrace), platform="CUDA")
        sm = ctypes.c_int()
        bps = ctypes.c_int()
        dev = jax.devices()[0].local_hardware_id or 0
        err = lib.tpu_rt_trace_occupancy(dev, ctypes.byref(sm), ctypes.byref(bps))
        if err != 0:
            raise RuntimeError(f"CUDA occupancy query failed (cudaError {err})")
        block = lib.tpu_rt_trace_block_threads()
        if block != BLOCK_THREADS:
            raise RuntimeError(f"kernel block size {block} != {BLOCK_THREADS}")
        _state.update(lib=lib, build_s=build_s, sm_count=sm.value,
                      blocks_per_sm=bps.value)
        return dict(_state)


def cuda_routing() -> CudaRouting:
    info = load_kernel()
    return CudaRouting(info["sm_count"], info["blocks_per_sm"])
