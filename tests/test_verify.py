"""Oracle adjudication (tpu_rt.trace.verify), the compile-cache helper,
and the programs that must refuse to run without a GPU."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax

from tpu_rt.bvh import build_sbvh, flatten_bvh
from tpu_rt.core.types import Hits, make_rays
from tpu_rt.scene import Scene, procedural
from tpu_rt.trace import device_bvh, trace_wavefront
from tpu_rt.trace.verify import adjudicate, compare_hits, disputed, verify_on_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _oracle(ids, ts, us=None, vs=None):
    n = len(ids)
    return (np.asarray(ids, np.int32), np.asarray(ts, np.float32),
            np.asarray(us if us is not None else [0.3] * n, np.float32),
            np.asarray(vs if vs is not None else [0.3] * n, np.float32))


@pytest.mark.parametrize("got_tri,got_t,oracle,verdict", [
    (5, 1.0, _oracle([5], [1.0]), "exact"),
    (-1, 9.0, _oracle([-1], [9.0]), "exact"),
    (6, 1.0 + 1e-5, _oracle([5], [1.0]), "tie"),                   # same t, other triangle
    (6, 1.5, _oracle([5], [1.0], [0.0005], [0.3]), "graze"),        # oracle hit on an edge
    (6, 1.5, _oracle([5], [1.0]), "wrong"),                         # farther triangle
    (-1, 9.0, _oracle([5], [1.0]), "wrong"),                        # missed a hit
])
def test_adjudicate_closest_hit(got_tri, got_t, oracle, verdict):
    v = adjudicate(np.array([got_tri]), np.array([got_t], np.float32), oracle, any_hit=False)
    assert [k for k in ("exact", "tie", "graze", "wrong") if v[k][0]] == [verdict]


def test_adjudicate_any_hit():
    oracle = _oracle([5, -1, 7, -1], [1.0, 9.0, 2.0, 9.0])
    got = np.array([3, -1, -1, 4])
    v = adjudicate(got, np.zeros(4, np.float32), oracle, any_hit=True)
    # Any occluder will do; only hit/miss counts.
    np.testing.assert_array_equal(v["exact"], [True, True, False, False])
    np.testing.assert_array_equal(v["wrong"], [False, False, True, True])
    assert not v["tie"].any() and not v["graze"].any()


def test_disputed_masks():
    got_tri = np.array([1, 2, -1, 4])
    got_t = np.array([1.0, 2.0, 5.0, 4.0], np.float32)
    want_tri = np.array([1, 3, -1, 4])
    want_t = np.array([1.0, 2.0, 6.0, 4.1], np.float32)
    np.testing.assert_array_equal(disputed(got_tri, got_t, want_tri, want_t, False),
                                  [False, True, False, True])
    np.testing.assert_array_equal(disputed(got_tri, got_t, want_tri, want_t, True),
                                  [False, False, False, False])


@pytest.fixture(scope="module")
def blob():
    scene = Scene(procedural.make_blob(800, seed=90))
    flat = flatten_bvh(build_sbvh(scene), scene.tri_vtx_index, scene.vtx_pos)
    rng = np.random.default_rng(0)
    lo, hi = scene.bbox()
    size = float(np.linalg.norm(hi - lo))
    n = 400
    o = ((lo + hi) / 2 + rng.normal(size=(n, 3)) * size).astype(np.float32)
    d = rng.uniform(lo, hi, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = make_rays(o, d, np.zeros(n), np.full(n, 4 * size))
    return flat, device_bvh(flat), rays


def test_compare_hits_agreeing_tracers(blob):
    flat, dbvh, rays = blob
    report = verify_on_device(flat, dbvh, rays, False,
                              lambda r, ah: trace_wavefront(dbvh, r, any_hit=ah))
    assert report == {"rays": 400, "disputed": 0, "tie": 0, "graze": 0,
                      "wrong": 0, "first_wrong": []}


def test_compare_hits_catches_wrong_rays(blob):
    flat, dbvh, rays = blob
    want = trace_wavefront(dbvh, rays)
    tri = np.asarray(want.tri).copy()
    hit = np.nonzero(tri >= 0)[0][:3]
    t = np.asarray(want.t).copy()
    tri[hit] = -1  # a tracer that drops three hits
    t[hit] = np.asarray(rays.tmax)[hit]
    got = Hits(tri=tri, t=t, u=want.u, v=want.v)
    report = compare_hits(flat, rays, got, want, any_hit=False)
    assert report["disputed"] == 3 and report["wrong"] == 3
    assert [w["ray"] for w in report["first_wrong"]] == hit.tolist()
    assert report["first_wrong"][0]["got"][0] == -1
    assert report["first_wrong"][0]["oracle"][0] == int(np.asarray(want.tri)[hit[0]])


def test_verify_subsamples(blob):
    flat, dbvh, rays = blob
    report = verify_on_device(flat, dbvh, rays, True,
                              lambda r, ah: trace_wavefront(dbvh, r, any_hit=ah),
                              n_check=100)
    assert report["rays"] == 100 and report["wrong"] == 0


def test_compile_cache_env_set(monkeypatch):
    from tpu_rt.compile_cache import configure_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    assert configure_compile_cache() == "/somewhere/else"
    assert jax.config.jax_compilation_cache_dir == before  # left to JAX


def test_compile_cache_env_unset(monkeypatch):
    from tpu_rt.compile_cache import DEFAULT_DIR, configure_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        assert configure_compile_cache() == DEFAULT_DIR
        assert jax.config.jax_compilation_cache_dir == DEFAULT_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    # A fixed path inside the checkout, ignored by git.
    assert DEFAULT_DIR == os.path.join(ROOT, ".jax_cache")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_programs_refuse_cpu(script):
    """With no GPU the measurement programs exit non-zero and print no
    result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(ROOT, script)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert out.returncode == 2, out.stderr[-2000:]
    assert "needs an NVIDIA GPU" in out.stderr
    assert '"ok"' not in out.stdout and '"metric"' not in out.stdout
