"""Native C++ SBVH builder: agreement with the numpy semantic definition."""

import os

import numpy as np
import pytest

from tpu_rt import native
from tpu_rt.bvh import BuildParams, Platform
from tpu_rt.bvh.cache import build_flat_bvh
from tpu_rt.bvh.flatten import validate_flat_bvh
from tpu_rt.core.types import FlatBVH
from tpu_rt.scene import Scene, procedural
from tpu_rt.trace import intersect_brute, trace_flat_scalar

@pytest.fixture(scope="module", autouse=True)
def native_lib():
    """Build (or find) the native library; skip when it does not build."""
    if not native.native_available():
        pytest.skip(f"native build failed: {native.build_error()}")


@pytest.fixture(scope="module")
def scene():
    return Scene(procedural.make_blob(1500, seed=60))


def _rays(scene, n, seed=0):
    rng = np.random.default_rng(seed)
    lo, hi = scene.bbox()
    size = float(np.linalg.norm(hi - lo))
    origin = ((lo + hi) / 2 + rng.normal(size=(n, 3)) * size).astype(np.float32)
    target = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = target - origin
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return origin, d.astype(np.float32), np.zeros(n, np.float32), np.full(n, 4 * size, np.float32)


def test_native_builds_and_validates(scene):
    flat, stats = build_flat_bvh(scene, Platform.gpu(), BuildParams(), backend="native")
    validate_flat_bvh(flat, scene.num_triangles)
    assert stats.num_tris >= scene.num_triangles
    assert stats.sah_cost > 0


def test_native_quality_matches_numpy(scene):
    nf, ns = build_flat_bvh(scene, Platform.gpu(), BuildParams(), backend="native")
    pf, ps = build_flat_bvh(scene, Platform.gpu(), BuildParams(), backend="numpy")
    # Trees may differ in float tie-breaks; quality metrics must agree tightly.
    assert abs(ns.sah_cost - ps.sah_cost) / ps.sah_cost < 0.02
    assert abs(ns.num_tris - ps.num_tris) / max(1, ps.num_tris) < 0.02
    assert abs(ns.num_inner_nodes - ps.num_inner_nodes) / max(1, ps.num_inner_nodes) < 0.02


def test_native_trace_matches_brute(scene):
    flat, _ = build_flat_bvh(scene, Platform.gpu(), BuildParams(), backend="native")
    o, d, tmin, tmax = _rays(scene, 300)
    b_id, b_t, _, _ = intersect_brute(scene.triangles(), o, d, tmin, tmax)
    s_id, s_t, _, _ = trace_flat_scalar(flat, o, d, tmin, tmax)
    np.testing.assert_array_equal(s_id >= 0, b_id >= 0)
    hit = b_id >= 0
    np.testing.assert_allclose(s_t[hit], b_t[hit], rtol=1e-4, atol=1e-5)
    assert (s_id[hit] == b_id[hit]).mean() > 0.99


def test_native_deterministic(scene):
    a, _ = build_flat_bvh(scene, Platform.gpu(), BuildParams(), backend="native")
    b, _ = build_flat_bvh(scene, Platform.gpu(), BuildParams(), backend="native")
    np.testing.assert_array_equal(np.asarray(a.nodes), np.asarray(b.nodes))
    np.testing.assert_array_equal(np.asarray(a.tri_index), np.asarray(b.tri_index))


def test_native_empty_and_single():
    class Mini:
        def __init__(self, idx, pos):
            self.tri_vtx_index = np.asarray(idx, np.int32).reshape(-1, 3)
            self.vtx_pos = np.asarray(pos, np.float32).reshape(-1, 3)

    single = Mini([[0, 1, 2]], [[0, 0, 0], [1, 0, 0], [0, 1, 0]])
    flat, stats = build_flat_bvh(single, Platform.gpu(), BuildParams(), backend="native")
    validate_flat_bvh(flat, 1)
    o = np.array([[0.2, 0.2, -1.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0]], np.float32)
    sid, st, _, _ = trace_flat_scalar(flat, o, d, np.zeros(1, np.float32), np.full(1, 10.0, np.float32))
    assert sid[0] == 0 and np.isclose(st[0], 1.0)


def test_native_build_is_portable_and_keyed():
    """The library is compiled for the generic target (no -march=native)
    into the git-ignored build directory, under a name keyed by the
    source and the command."""
    from tpu_rt import _build

    assert not any(a.startswith("-march") for a in native._CMD)
    path = _build.library_path("libtpurt_native", native._SRC, native._CMD)
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.exists(path)
    other = _build.library_path("libtpurt_native", native._SRC, native._CMD + ["-g"])
    assert other != path


def test_build_library_atomic(tmp_path, monkeypatch):
    """build_library compiles once to a temporary name and moves the whole
    file into place; a failed build raises and leaves no file behind."""
    from tpu_rt import _build

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    src = tmp_path / "one.cc"
    src.write_text('extern "C" int one() { return 1; }\n')
    cmd = ["g++", "-shared", "-fPIC", str(src), "-o", "{out}"]
    path = _build.build_library("libone", str(src), cmd)
    assert os.path.exists(path)
    mtime = os.path.getmtime(path)
    assert _build.build_library("libone", str(src), cmd) == path
    assert os.path.getmtime(path) == mtime  # reused, not rebuilt
    import ctypes

    assert ctypes.CDLL(path).one() == 1
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="failed"):
        _build.build_library("libbad", str(bad), ["g++", "-shared", "-fPIC", str(bad), "-o", "{out}"])
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(["one.cc", "bad.cc", os.path.basename(path)])
