"""The CUDA traversal kernel: its Python side on the CPU, the kernel itself
on the GPU (tests marked `gpu`; run `python -m pytest --gpu -m gpu tests/`
on a machine with a card)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpu_rt.bvh import build_sbvh, flatten_bvh
from tpu_rt.core.types import FlatBVH, make_rays
from tpu_rt.scene import Scene, procedural
from tpu_rt.trace import cuda_tracer, make_routing_tracer, trace_flat_scalar
from tpu_rt.trace.cuda_tracer import (
    BLOCK_THREADS,
    CudaRouting,
    launch_grid,
    pack_rays,
    trace_cuda,
    unpack_results,
)


def _rays(scene, n, seed=0):
    rng = np.random.default_rng(seed)
    lo, hi = scene.bbox()
    size = float(np.linalg.norm(hi - lo))
    origin = ((lo + hi) / 2 + rng.normal(size=(n, 3)) * size).astype(np.float32)
    target = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = target - origin
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return origin, d.astype(np.float32), np.zeros(n, np.float32), np.full(n, 4 * size, np.float32)


# ---- the Python side, on the CPU ----


def test_pack_rays_layout():
    o = np.arange(12, dtype=np.float32).reshape(4, 3)
    d = -o - 1
    rays = make_rays(o, d, np.full(4, 0.5), np.array([1, 2, -1, 4], np.float32))
    packed = np.asarray(pack_rays(rays))
    assert packed.shape == (4, 8) and packed.dtype == np.float32
    np.testing.assert_array_equal(packed[:, 0:3], o)
    np.testing.assert_array_equal(packed[:, 3], 0.5)
    np.testing.assert_array_equal(packed[:, 4:7], d)
    # tmax (and the degenerate tmax < 0 marker) rides in the 8th float.
    np.testing.assert_array_equal(packed[:, 7], [1, 2, -1, 4])


def test_unpack_results_bits():
    t = np.array([0.25, -1.0, np.inf, 3.5e-20], np.float32)
    out = np.stack([np.array([7, -1, -1, 0], np.int32), t.view(np.int32)], axis=1)
    hits = unpack_results(jnp.asarray(out))
    np.testing.assert_array_equal(np.asarray(hits.tri), [7, -1, -1, 0])
    np.testing.assert_array_equal(np.asarray(hits.t).view(np.int32), t.view(np.int32))
    assert not np.asarray(hits.u).any() and not np.asarray(hits.v).any()


@pytest.mark.parametrize("n,sms,bps,expect", [
    (0, 132, 12, 0),                           # nothing to trace
    (1, 132, 12, 1),                           # one block for one ray
    (BLOCK_THREADS * 10 + 1, 132, 12, 11),     # fewer rays than the card holds
    (307_200, 132, 12, 132 * 12),              # a full frame fills every SM
    (5_000_000, 132, 0, 132),                  # occupancy 0 still launches
])
def test_launch_grid(n, sms, bps, expect):
    assert launch_grid(n, sms, bps) == expect


def test_cuda_routing_hashable():
    a, b, c = CudaRouting(132, 12), CudaRouting(132, 12), CudaRouting(114, 12)
    assert a == b and hash(a) == hash(b)
    assert a != c
    assert a != (lambda t, r, any_hit=False: None)
    assert len({a, b, c}) == 2


def test_trace_cuda_empty_scene_is_all_misses():
    """With no geometry the wrapper answers without calling the kernel."""
    empty = FlatBVH(nodes=jnp.zeros((0, 16), jnp.float32),
                    tri_woop=jnp.zeros((0, 12), jnp.float32),
                    tri_index=jnp.zeros((0,), jnp.int32),
                    leaf_counts=jnp.zeros((1,), jnp.int32))
    rays = make_rays(np.zeros((3, 3)), np.ones((3, 3)), np.zeros(3), np.array([1.0, 2.0, -1.0]))
    hits = trace_cuda(empty, rays, any_hit=False, grid=1)
    np.testing.assert_array_equal(np.asarray(hits.tri), -1)
    np.testing.assert_array_equal(np.asarray(hits.t), [1.0, 2.0, -1.0])


def test_routing_choice_on_cpu():
    scene = Scene(procedural.make_cube())
    flat = flatten_bvh(build_sbvh(scene), scene.tri_vtx_index, scene.vtx_pos)
    fn, kind, tables = make_routing_tracer(flat)
    assert kind == "xla"
    assert make_routing_tracer(flat, prefer="xla")[0] == fn
    assert isinstance(tables.nodes, jax.Array)
    with pytest.raises(RuntimeError, match="GPU backend"):
        make_routing_tracer(flat, prefer="cuda")
    with pytest.raises(ValueError, match="tracer must be one of"):
        make_routing_tracer(flat, prefer="pallas")


def test_load_kernel_refuses_cpu():
    with pytest.raises(RuntimeError, match="GPU backend"):
        cuda_tracer.load_kernel()


def test_nvcc_command_targets_hopper():
    cmd = cuda_tracer.nvcc_command("nvcc")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1] == cuda_tracer.SRC and cuda_tracer.SRC.endswith("traverse.cu")
    assert "{out}" in cmd and "-shared" in cmd
    assert "-fmad=false" in cmd  # rounding as in the oracle
    assert jax.ffi.include_dir() in cmd


# ---- the kernel, on the card ----


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, mesh in (("blob", procedural.make_blob(3000, seed=80)),
                       ("interior", procedural.make_interior(2000, seed=81)),
                       ("hairball", procedural.make_hairball(2000, seed=82))):
        scene = Scene(mesh)
        out[name] = (scene, flatten_bvh(build_sbvh(scene), scene.tri_vtx_index, scene.vtx_pos))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["blob", "interior", "hairball"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_cuda_kernel_matches_oracle(gpu, scenes, name, any_hit):
    from tpu_rt.trace.verify import compare_hits

    scene, flat = scenes[name]
    o, d, tmin, tmax = _rays(scene, 3000, seed=5)
    tmax[::7] = -1.0
    rays = make_rays(o, d, tmin, tmax)
    fn, kind, tables = make_routing_tracer(flat, prefer="cuda")
    assert kind == "cuda"
    got = fn(tables, rays, any_hit=any_hit)
    assert np.all(np.asarray(got.tri)[::7] == -1)
    s_id, s_t, s_u, s_v = trace_flat_scalar(flat, o, d, tmin, tmax, any_hit=any_hit)
    want = type(got)(tri=jnp.asarray(s_id), t=jnp.asarray(s_t), u=jnp.asarray(s_u), v=jnp.asarray(s_v))
    report = compare_hits(flat, rays, got, want, any_hit)
    assert report["wrong"] == 0, report


@pytest.mark.gpu
def test_cuda_kernel_odd_sizes(gpu, scenes):
    scene, flat = scenes["blob"]
    fn, _, tables = make_routing_tracer(flat, prefer="cuda")
    for n in (1, 31, 33, BLOCK_THREADS + 1):
        o, d, tmin, tmax = _rays(scene, n, seed=n)
        got = fn(tables, make_rays(o, d, tmin, tmax))
        s_id, _, _, _ = trace_flat_scalar(flat, o, d, tmin, tmax)
        np.testing.assert_array_equal(np.asarray(got.tri), s_id)


@pytest.mark.gpu
def test_cuda_kernel_repeatable(gpu, scenes):
    """The work counter is per call: back-to-back calls trace every ray."""
    scene, flat = scenes["interior"]
    fn, _, tables = make_routing_tracer(flat, prefer="cuda")
    rays = make_rays(*_rays(scene, 5000, seed=9))
    a = fn(tables, rays)
    b = fn(tables, rays)
    np.testing.assert_array_equal(np.asarray(a.tri), np.asarray(b.tri))
    np.testing.assert_array_equal(np.asarray(a.t), np.asarray(b.t))
