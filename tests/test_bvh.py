import os
import numpy as np
import pytest

from tpu_rt.bvh import BuildParams, Platform, build_sbvh, flatten_bvh, load_or_build_bvh
from tpu_rt.bvh.flatten import validate_flat_bvh, woopify
from tpu_rt.scene import Scene, procedural


@pytest.fixture(scope="module")
def blob_scene():
    return Scene(procedural.make_blob(2000, seed=5))


def test_build_basic(blob_scene):
    bvh = build_sbvh(blob_scene)
    s = bvh.stats
    assert s.num_leaf_nodes > 0
    assert s.num_inner_nodes == s.num_leaf_nodes - 1  # binary tree invariant
    assert s.num_tris >= blob_scene.num_triangles  # duplicates only add
    assert s.sah_cost > 0
    # Leaf sizes bounded by the GPU platform's max (8), given depth allows.
    def max_leaf(node):
        if node.is_leaf:
            return node.num_tris()
        return max(max_leaf(node.left), max_leaf(node.right))
    assert max_leaf(bvh.root) <= 8


def test_flatten_valid(blob_scene):
    bvh = build_sbvh(blob_scene)
    flat = flatten_bvh(bvh, blob_scene.tri_vtx_index, blob_scene.vtx_pos)
    assert flat.nodes.shape[1] == 16
    assert flat.tri_woop.shape[0] == bvh.stats.num_tris
    assert flat.leaf_counts.shape[0] == flat.tri_woop.shape[0] + 1
    validate_flat_bvh(flat, blob_scene.num_triangles)
    # Per-leaf counts sum to the total refs.
    assert int(np.asarray(flat.leaf_counts).sum()) == flat.tri_woop.shape[0]


def test_woop_transform_unit_triangle():
    # The Woop transform maps the triangle to the unit triangle: for a point
    # p on the triangle plane, z(p)=0; at v0 (u=1,v=0); at v1 (u=0,v=1).
    tri_vtx = np.array([[0, 1, 2]], np.int32)
    rng = np.random.default_rng(3)
    vtx = rng.normal(size=(3, 3)).astype(np.float32)
    w = woopify(tri_vtx, vtx, [0])[0]
    v0, v1, v2 = vtx

    def uvz(p):
        z = -(w[3] - p @ w[0:3])  # kernel computes Oz = w3 - o.wz = -z(o)
        u = w[7] + p @ w[4:7]
        v = w[11] + p @ w[8:11]
        return u, v, z

    u, v, z = uvz(v0)
    np.testing.assert_allclose([u, v, z], [1, 0, 0], atol=1e-5)
    u, v, z = uvz(v1)
    np.testing.assert_allclose([u, v, z], [0, 1, 0], atol=1e-5)
    u, v, z = uvz(v2)
    np.testing.assert_allclose([u, v, z], [0, 0, 0], atol=1e-5)


def test_degenerate_triangles_culled():
    # Zero-area and line triangles are removed (SplitBVHBuilder.cc:134-143).
    pos = np.array(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [2, 0, 0], [3, 0, 0]], np.float32
    )
    idx = np.array([[0, 1, 2], [0, 3, 4], [1, 1, 1]], np.int32)  # good, line, point

    class MiniScene:
        tri_vtx_index = idx
        vtx_pos = pos

    bvh = build_sbvh(MiniScene())
    assert bvh.stats.num_tris == 1
    assert set(bvh.tri_indices.tolist()) == {0}


def test_spatial_splits_fire():
    # Long thin *diagonal* slivers are the SBVH showcase: axis-aligned object
    # splits can't separate them but chopping can -> duplicated references.
    rng = np.random.default_rng(11)
    n = 300
    base = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    along = np.array([1.0, 1.0, 1.0], np.float32)
    v0 = base
    v1 = base + along * 1.5 + np.array([0.01, -0.01, 0.0], np.float32)
    v2 = base + along * 0.75 + np.array([0.02, 0.02, -0.02], np.float32)
    pos = np.concatenate([v0, v1, v2]).astype(np.float32)
    idx = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n], axis=1).astype(np.int32)

    class MiniScene:
        tri_vtx_index = idx
        vtx_pos = pos

    bvh = build_sbvh(MiniScene(), params=BuildParams(split_alpha=1e-5))
    assert bvh.stats.num_duplicates > 0
    # With splitting disabled (alpha=inf gate never passes), no duplicates.
    bvh2 = build_sbvh(MiniScene(), params=BuildParams(split_alpha=1e9))
    assert bvh2.stats.num_duplicates == 0
    # SBVH should not be worse in SAH.
    assert bvh.stats.sah_cost <= bvh2.stats.sah_cost * 1.01


def test_cache_roundtrip(tmp_path, blob_scene):
    flat1, stats1 = load_or_build_bvh(blob_scene, cache_dir=str(tmp_path))
    files = list(tmp_path.iterdir())
    assert len(files) == 1
    flat2, stats2 = load_or_build_bvh(blob_scene, cache_dir=str(tmp_path))
    np.testing.assert_array_equal(np.asarray(flat1.nodes), np.asarray(flat2.nodes))
    np.testing.assert_array_equal(np.asarray(flat1.tri_woop), np.asarray(flat2.tri_woop))
    np.testing.assert_array_equal(np.asarray(flat1.tri_index), np.asarray(flat2.tri_index))
    np.testing.assert_array_equal(np.asarray(flat1.leaf_counts), np.asarray(flat2.leaf_counts))
    assert stats1.num_inner_nodes == stats2.num_inner_nodes
    assert stats1.sah_cost == pytest.approx(stats2.sah_cost)
    # Different build params -> different key -> second file.
    load_or_build_bvh(blob_scene, params=BuildParams(split_alpha=0.5), cache_dir=str(tmp_path))
    assert len(list(tmp_path.iterdir())) == 2


def test_builder_determinism(blob_scene):
    a = build_sbvh(blob_scene)
    b = build_sbvh(blob_scene)
    np.testing.assert_array_equal(a.tri_indices, b.tri_indices)
    assert a.stats.sah_cost == b.stats.sah_cost
    assert a.stats.num_inner_nodes == b.stats.num_inner_nodes


def test_cache_key_stable_across_processes():
    """The BVH cache key must be process-invariant: python's builtin
    str hash is PYTHONHASHSEED-salted, and a salted component silently
    turned every new process into a cache miss (hairball-class scenes
    then rebuilt ~6.5 min per run)."""
    import subprocess
    import sys as _sys

    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from tpu_rt.scene import Scene, procedural\n"
        "from tpu_rt.bvh.cache import bvh_cache_key, platform_from_env\n"
        "from tpu_rt.bvh.builder import BuildParams\n"
        "s = Scene(procedural.make_quad())\n"
        "print(hex(bvh_cache_key(s, platform_from_env(), BuildParams())))\n"
    ) % os.path.join(os.path.dirname(__file__), "..")
    keys = set()
    for seed in ("0", "12345"):
        env = dict(os.environ, PYTHONHASHSEED=seed, JAX_PLATFORMS="cpu")
        out = subprocess.run([_sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, check=True)
        keys.add(out.stdout.strip())
    assert len(keys) == 1, keys


def _rays(scene, n, seed=0):
    rng = np.random.default_rng(seed)
    lo, hi = scene.bbox()
    size = float(np.linalg.norm(hi - lo))
    origin = ((lo + hi) / 2 + rng.normal(size=(n, 3)) * size).astype(np.float32)
    target = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = target - origin
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return origin, d.astype(np.float32), np.zeros(n, np.float32), np.full(n, 4 * size, np.float32)


@pytest.fixture(scope="module")
def quad_setup():
    from tpu_rt.bvh.collapse import collapse4, validate_quad

    scene = Scene(procedural.make_blob(700, seed=80))
    flat = flatten_bvh(build_sbvh(scene), scene.tri_vtx_index, scene.vtx_pos)
    quad = collapse4(flat)
    validate_quad(quad, scene.num_triangles)
    return scene, flat, quad


def test_collapse4_oracle_parity(quad_setup):
    """Quad traversal is the same geometry query: hit/miss classification
    and t must be EXACTLY the binary oracle's (same per-triangle f32
    arithmetic; only the tested-triangle sets differ, which cannot
    change a closest hit — ids may differ solely on exact-t ties)."""
    from tpu_rt.bvh.collapse import trace_quad_scalar
    from tpu_rt.trace import trace_flat_scalar

    scene, flat, quad = quad_setup
    o, d, tmin, tmax = _rays(scene, 900, seed=40)
    tmax[::6] = -1.0
    s_id, s_t, _, _ = trace_flat_scalar(flat, o, d, tmin, tmax)
    q_id, q_t, _, _ = trace_quad_scalar(quad, o, d, tmin, tmax)
    np.testing.assert_array_equal(q_t, s_t)
    dis = q_id != s_id
    assert np.all(q_t[dis] == s_t[dis])  # only exact-t ties may differ


def test_quad_cache_roundtrip(tmp_path, quad_setup):
    """load_or_collapse_quad: a cache miss collapses and writes one entry;
    a hit returns identical arrays without a second entry."""
    from tpu_rt.bvh import load_or_collapse_quad

    _, flat, quad = quad_setup
    q1 = load_or_collapse_quad(flat, cache_dir=str(tmp_path))
    n_files = len(list(tmp_path.iterdir()))
    assert n_files == 1
    q2 = load_or_collapse_quad(flat, cache_dir=str(tmp_path))
    assert len(list(tmp_path.iterdir())) == n_files
    for a, b in zip(q1, q2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(q1.nodes), np.asarray(quad.nodes))
