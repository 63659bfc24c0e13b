import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpu_rt.bvh import build_sbvh, flatten_bvh
from tpu_rt.core.types import Rays, make_rays
from tpu_rt.scene import Camera, Scene, procedural
from tpu_rt.trace import RayStats, device_bvh, intersect_brute, trace_flat_scalar, trace_wavefront


def _scene_and_flat(mesh):
    scene = Scene(mesh)
    bvh = build_sbvh(scene)
    flat = flatten_bvh(bvh, scene.tri_vtx_index, scene.vtx_pos)
    return scene, flat


def _random_rays(scene, n, seed=0, from_outside=True):
    rng = np.random.default_rng(seed)
    lo, hi = scene.bbox()
    center = (lo + hi) / 2
    size = float(np.linalg.norm(hi - lo))
    if from_outside:
        origin = center + rng.normal(size=(n, 3)) * size
    else:
        origin = rng.uniform(lo, hi, (n, 3))
    target = rng.uniform(lo, hi, (n, 3))
    dirn = target - origin
    dirn /= np.linalg.norm(dirn, axis=1, keepdims=True)
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, 4 * size, np.float32)
    return origin.astype(np.float32), dirn.astype(np.float32), tmin, tmax


@pytest.fixture(scope="module")
def blob():
    return _scene_and_flat(procedural.make_blob(1500, seed=21))


def test_scalar_tracer_matches_brute(blob):
    scene, flat = blob
    o, d, tmin, tmax = _random_rays(scene, 200, seed=1)
    tris = scene.triangles()

    b_id, b_t, b_u, b_v = intersect_brute(tris, o, d, tmin, tmax)
    s_id, s_t, s_u, s_v = trace_flat_scalar(flat, o, d, tmin, tmax)

    # Same hit/miss classification everywhere.
    np.testing.assert_array_equal(s_id >= 0, b_id >= 0)
    hit = b_id >= 0
    # t agrees tightly; ids may differ only where two triangles are
    # (near-)coincident at the same t.
    np.testing.assert_allclose(s_t[hit], b_t[hit], rtol=1e-4, atol=1e-5)
    same = s_id == b_id
    assert same[hit].mean() > 0.99


def test_wavefront_matches_scalar(blob):
    scene, flat = blob
    o, d, tmin, tmax = _random_rays(scene, 500, seed=2)
    s_id, s_t, s_u, s_v = trace_flat_scalar(flat, o, d, tmin, tmax)

    dbvh = device_bvh(flat)
    rays = make_rays(o, d, tmin, tmax)
    hits = trace_wavefront(dbvh, rays)
    w_id = np.asarray(hits.tri)
    w_t = np.asarray(hits.t)

    np.testing.assert_array_equal(w_id, s_id)
    hit = s_id >= 0
    np.testing.assert_allclose(w_t[hit], s_t[hit], rtol=1e-6, atol=1e-7)
    # u/v see FMA/reassociation differences between XLA and the scalar oracle.
    np.testing.assert_allclose(np.asarray(hits.u)[hit], s_u[hit], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(hits.v)[hit], s_v[hit], rtol=1e-3, atol=1e-4)


def test_any_hit_semantics(blob):
    scene, flat = blob
    o, d, tmin, tmax = _random_rays(scene, 300, seed=3)
    c_id, c_t, _, _ = trace_flat_scalar(flat, o, d, tmin, tmax, any_hit=False)
    a_id, a_t, _, _ = trace_flat_scalar(flat, o, d, tmin, tmax, any_hit=True)

    # anyHit finds a hit iff closest-hit does; its t is >= closest (it stops
    # at the first accepted intersection, not necessarily the nearest).
    np.testing.assert_array_equal(a_id >= 0, c_id >= 0)
    hit = c_id >= 0
    assert np.all(a_t[hit] >= c_t[hit] - 1e-6)

    dbvh = device_bvh(flat)
    rays = make_rays(o, d, tmin, tmax)
    w = trace_wavefront(dbvh, rays, any_hit=True)
    np.testing.assert_array_equal(np.asarray(w.tri) >= 0, c_id >= 0)


def test_degenerate_rays_skip(blob):
    scene, flat = blob
    o, d, tmin, tmax = _random_rays(scene, 64, seed=4)
    tmax[::2] = -1.0  # degenerate (reference RayGenKernels.cu:221)
    s_id, _, _, _ = trace_flat_scalar(flat, o, d, tmin, tmax)
    assert np.all(s_id[::2] == -1)
    hits = trace_wavefront(device_bvh(flat), make_rays(o, d, tmin, tmax))
    np.testing.assert_array_equal(np.asarray(hits.tri)[::2], -1)
    # Stats: degenerate lanes do zero work.
    _, st = trace_wavefront(device_bvh(flat), make_rays(o, d, tmin, tmax), with_stats=True)
    assert np.all(np.asarray(st["node_tests"])[::2] == 0)


def test_tmin_tmax_respected(blob):
    scene, flat = blob
    o, d, tmin, tmax = _random_rays(scene, 200, seed=5)
    base_id, base_t, _, _ = trace_flat_scalar(flat, o, d, tmin, tmax)
    hit = base_id >= 0
    # Clamp tmax below the hit -> must miss.
    tmax2 = np.where(hit, base_t * 0.9, tmax).astype(np.float32)
    id2, _, _, _ = trace_flat_scalar(flat, o, d, tmin, tmax2)
    assert np.all(id2[hit] == -1) or np.mean(id2[hit] == -1) > 0.98  # grazing cases
    # Raise tmin above the hit -> different (or no) hit, never the same t.
    tmin2 = np.where(hit, base_t * 1.001, tmin).astype(np.float32)
    id3, t3, _, _ = trace_flat_scalar(flat, o, d, tmin2, tmax)
    assert np.all(t3[hit] >= base_t[hit])


def test_inside_rays(blob):
    # Rays starting inside the model (AO-style) still agree with brute force.
    scene, flat = blob
    o, d, tmin, tmax = _random_rays(scene, 150, seed=6, from_outside=False)
    b_id, b_t, _, _ = intersect_brute(scene.triangles(), o, d, tmin, tmax)
    s_id, s_t, _, _ = trace_flat_scalar(flat, o, d, tmin, tmax)
    np.testing.assert_array_equal(s_id >= 0, b_id >= 0)
    hit = b_id >= 0
    np.testing.assert_allclose(s_t[hit], b_t[hit], rtol=1e-4, atol=1e-5)


def test_stats_counters(blob):
    scene, flat = blob
    o, d, tmin, tmax = _random_rays(scene, 50, seed=7)
    stats = RayStats()
    trace_flat_scalar(flat, o, d, tmin, tmax, stats=stats)
    assert stats.num_rays == 50
    assert stats.num_node_tests > 0
    assert stats.num_triangle_tests > 0
    _, wst = trace_wavefront(device_bvh(flat), make_rays(o, d, tmin, tmax), with_stats=True)
    np.testing.assert_array_equal(np.asarray(wst["node_tests"]), stats.per_ray_node_tests)
    np.testing.assert_array_equal(np.asarray(wst["tri_tests"]), stats.per_ray_tri_tests)


def test_treelet_counter(blob):
    """numTreelets (reference BVH.hh:48, BVH.cc:89-99): with no treelet
    assignment every node shares id -1 -> exactly 1 transition per
    traced ray (the reference's unassigned-default behavior); with a
    real partition (assign_treelets) the count is >= the node-test
    count / treelet size and bounded by the node-test count."""
    from tpu_rt.trace import assign_treelets

    scene, flat = blob
    o, d, tmin, tmax = _random_rays(scene, 60, seed=9)
    tmax[::4] = -1.0  # degenerate rays never enter the tree
    st0 = RayStats()
    trace_flat_scalar(flat, o, d, tmin, tmax, stats=st0)
    traced = np.sum(tmax >= 0)
    assert st0.num_treelets == traced  # all-(-1) default: 1/ray
    assert np.all(st0.per_ray_treelets[tmax < 0] == 0)

    tl = assign_treelets(flat, max_nodes=32)
    n_inner = np.asarray(flat.nodes).shape[0]
    assert tl.shape == (n_inner,) and np.all(tl >= 0)
    # Partition budget respected and every treelet non-empty.
    counts = np.bincount(tl)
    assert counts.max() <= 32 and counts.min() >= 1
    st1 = RayStats()
    trace_flat_scalar(flat, o, d, tmin, tmax, stats=st1, treelets=tl)
    # Transitions are bounded by node visits and at least 1 per traced
    # ray; a real partition transitions strictly more than the default.
    assert st1.num_treelets >= traced
    assert st1.num_treelets <= st1.num_node_tests
    assert st1.num_treelets >= st0.num_treelets
    assert np.all(st1.per_ray_treelets <= st1.per_ray_node_tests)


def test_interior_scene_wavefront():
    scene, flat = _scene_and_flat(procedural.make_interior(1200, seed=22))
    o, d, tmin, tmax = _random_rays(scene, 100, seed=8, from_outside=False)
    s_id, s_t, _, _ = trace_flat_scalar(flat, o, d, tmin, tmax)
    hits = trace_wavefront(device_bvh(flat), make_rays(o, d, tmin, tmax))
    np.testing.assert_array_equal(np.asarray(hits.tri), s_id)
    # Interior rays nearly always hit something (closed room).
    assert (s_id >= 0).mean() > 0.95


# ---- the plain reference against the oracle, across scenes and ray types ----

_MATRIX_SCENES = {
    "knob": lambda: procedural.make_blob(600, seed=10, roughness=0.08, ground=True),
    "interior": lambda: procedural.make_interior(900, seed=11),
    "hairball": lambda: procedural.make_hairball(900, seed=13),
}


@pytest.fixture(scope="module")
def matrix_scenes():
    out = {}
    for name, make in _MATRIX_SCENES.items():
        scene, flat = _scene_and_flat(make())
        out[name] = (scene, flat, device_bvh(flat))
    return out


def _matrix_rays(name, scene, dbvh, ray_type):
    """Primary-like rays (from outside toward the model; inside the room
    for the interior), or AO / diffuse rays spawned from their hits."""
    from tpu_rt.raygen.generators import gen_ao_rays

    rays = make_rays(*_random_rays(scene, 192, seed=11, from_outside=name != "interior"))
    if ray_type == "primary":
        return rays
    hits = trace_wavefront(dbvh, rays)
    lo, hi = scene.bbox()
    size = float(np.linalg.norm(hi - lo))
    dist = 0.25 * size if ray_type == "ao" else 4 * size
    sec, _, _ = gen_ao_rays(rays.origin, rays.dirn, hits.t, hits.tri,
                            jnp.asarray(scene.tri_normal), 2, jnp.float32(dist),
                            jnp.uint32(5))
    return sec


@pytest.mark.parametrize("scene_name", sorted(_MATRIX_SCENES))
@pytest.mark.parametrize("ray_type", ["primary", "ao", "diffuse"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_wavefront_oracle_matrix(matrix_scenes, scene_name, ray_type, any_hit):
    """trace_wavefront is the reference the CUDA kernel is judged against;
    it must agree with the scalar oracle on every ray of every scene
    class and ray type, closest and any hit."""
    from tpu_rt.core.types import Hits
    from tpu_rt.trace.verify import compare_hits

    scene, flat, dbvh = matrix_scenes[scene_name]
    rays = _matrix_rays(scene_name, scene, dbvh, ray_type)
    got = trace_wavefront(dbvh, rays, any_hit=any_hit)
    o, d = np.asarray(rays.origin), np.asarray(rays.dirn)
    oracle = trace_flat_scalar(flat, o, d, np.asarray(rays.tmin),
                               np.asarray(rays.tmax), any_hit=any_hit)
    want = Hits(*oracle)
    report = compare_hits(flat, rays, got, want, any_hit)
    assert report["disputed"] == 0, report
    assert (oracle[0] >= 0).any()  # the case traces real hits


def test_woop_tuv_is_the_oracle_arithmetic():
    """The reference's triangle test is elementwise (never a dot product,
    so a GPU cannot run it in TF32) and follows the oracle's operation
    order: t = Oz * (1/Dz) with sequential sums.  XLA may still contract
    a product and a sum into one FMA, so values agree to a few ulps."""
    from tpu_rt.trace.xla_tracer import woop_tuv

    rng = np.random.default_rng(0)
    n = 4096
    w = rng.normal(size=(n, 12)).astype(np.float32)
    o = rng.normal(size=(n, 3)).astype(np.float32) * 10
    d = rng.normal(size=(n, 3)).astype(np.float32)
    args = (jnp.asarray(w), jnp.asarray(o), jnp.asarray(d))
    assert "dot_general" not in str(jax.make_jaxpr(woop_tuv)(*args))
    t, u, v = jax.jit(woop_tuv)(*args)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        oz = w[:, 3] - o[:, 0] * w[:, 0] - o[:, 1] * w[:, 1] - o[:, 2] * w[:, 2]
        dz = d[:, 0] * w[:, 0] + d[:, 1] * w[:, 1] + d[:, 2] * w[:, 2]
        t_ref = oz * (np.float32(1.0) / dz)
        u_ref = (w[:, 7] + o[:, 0] * w[:, 4] + o[:, 1] * w[:, 5] + o[:, 2] * w[:, 6]) + t_ref * (
            d[:, 0] * w[:, 4] + d[:, 1] * w[:, 5] + d[:, 2] * w[:, 6])
        v_ref = (w[:, 11] + o[:, 0] * w[:, 8] + o[:, 1] * w[:, 9] + o[:, 2] * w[:, 10]) + t_ref * (
            d[:, 0] * w[:, 8] + d[:, 1] * w[:, 9] + d[:, 2] * w[:, 10])
    ok = np.abs(t_ref) < 1e3  # away from Dz ~ 0, where cancellation rules
    np.testing.assert_allclose(np.asarray(t)[ok], t_ref[ok], rtol=1e-4, atol=1e-5)
    for got, ref in ((u, u_ref), (v, v_ref)):
        np.testing.assert_allclose(np.asarray(got)[ok], ref[ok], rtol=1e-3, atol=1e-3)


def test_shading_pinned_precision_same_bits():
    """Pinning the Lambert dot to full float32 changes nothing on the CPU:
    the pinned shading gives the same bits as the unpinned matmul."""
    from tpu_rt.diff.shading import LIGHT, shade_hits_diff
    from tpu_rt.shade.reconstruct import BG_COLOR

    scene = Scene(procedural.make_blob(400, seed=4))
    vtx = jnp.asarray(scene.vtx_pos)
    tvi = jnp.asarray(scene.tri_vtx_index)
    mat = jnp.asarray(scene.tri_material)
    tri = jnp.asarray(np.random.default_rng(1).integers(-1, scene.num_triangles, 512), jnp.int32)
    got = shade_hits_diff(tri, vtx, tvi, mat)

    v0, v1, v2 = vtx[tvi[:, 0]], vtx[tvi[:, 1]], vtx[tvi[:, 2]]
    n = jnp.cross(v1 - v0, v2 - v0)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
    lambert = n @ jnp.asarray(LIGHT) * 0.5 + 0.5  # the unpinned form
    table = mat[:, :3] * lambert[:, None]
    want = jnp.where((tri >= 0)[:, None], table[jnp.clip(tri, 0, None)],
                     jnp.asarray(BG_COLOR[:3])[None, :])
    np.testing.assert_array_equal(np.asarray(got).view(np.int32), np.asarray(want).view(np.int32))
