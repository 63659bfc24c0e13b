import numpy as np
import pytest

from tpu_rt.core.math import from_abgr
from tpu_rt.scene import Camera, Scene, import_wavefront_mesh, export_wavefront_mesh, procedural
from tpu_rt.scene.camera import fit_to_view, perspective


OBJ_TEXT = """
# demo object
mtllib demo.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 1
vt 0 0
vt 1 0
vt 1 1
vn 0 0 1
usemtl red
f 1/1/1 2/2/1 3/3/1
f 1 3 4
usemtl blue
f -5/-3 -4/-2 -1/-1
f 1 2 3 4
"""

MTL_TEXT = """
newmtl red
Kd 1 0 0
Ns 10
newmtl blue
Kd 0 0 1
d 0.5
"""


@pytest.fixture
def obj_path(tmp_path):
    (tmp_path / "demo.obj").write_text(OBJ_TEXT)
    (tmp_path / "demo.mtl").write_text(MTL_TEXT)
    return str(tmp_path / "demo.obj")


def test_obj_import(obj_path):
    mesh = import_wavefront_mesh(obj_path)
    # Two submeshes (red, blue); the quad fans into 2 tris.
    assert len(mesh.submeshes) == 2
    assert mesh.submeshes[0].shape[0] == 2
    assert mesh.submeshes[1].shape[0] == 3  # 1 negative-index tri + quad fan 2
    assert mesh.materials[0].name == "red"
    np.testing.assert_allclose(mesh.materials[0].diffuse[:3], [1, 0, 0])
    assert mesh.materials[1].diffuse[3] == 0.5
    # Vertex welding: corner '1/1/1' differs from corner '1' (no tex/normal).
    assert mesh.num_vertices >= 5
    # Negative indices resolve relative to the current vertex count.
    tri = mesh.submeshes[1][0]
    np.testing.assert_allclose(mesh.positions[tri[0]], [0, 0, 0])
    np.testing.assert_allclose(mesh.positions[tri[2]], [0, 0, 1])


def test_obj_texcoord_v_flip(tmp_path):
    p = tmp_path / "t.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0.25 0.25\nf 1/1 2/1 3/1\n")
    mesh = import_wavefront_mesh(str(p))
    np.testing.assert_allclose(mesh.texcoords[0], [0.25, 0.75])


def test_obj_roundtrip(tmp_path, obj_path):
    mesh = import_wavefront_mesh(obj_path)
    out = str(tmp_path / "rt.obj")
    export_wavefront_mesh(mesh, out)
    mesh2 = import_wavefront_mesh(out)
    assert mesh2.num_triangles == mesh.num_triangles
    s1 = Scene(mesh)
    s2 = Scene(mesh2)
    np.testing.assert_allclose(s2.vtx_pos[s2.tri_vtx_index], s1.vtx_pos[s1.tri_vtx_index], atol=1e-6)


def test_scene_flatten(obj_path):
    mesh = import_wavefront_mesh(obj_path)
    scene = Scene(mesh)
    assert scene.num_triangles == 5
    assert scene.tri_vtx_index.shape == (5, 3)
    # Geometric normals are unit length.
    np.testing.assert_allclose(np.linalg.norm(scene.tri_normal, axis=1), 1.0, atol=1e-6)
    # Shaded color = diffuse * (dot(n, light)*0.5+0.5) with alpha 1.
    n0 = scene.tri_normal[0]
    lam = float(n0 @ Scene.LIGHT) * 0.5 + 0.5
    rgba = from_abgr(scene.tri_shaded_u32[0])
    np.testing.assert_allclose(rgba[:3], np.clip([1 * lam, 0, 0], 0, 1), atol=1 / 255)
    assert rgba[3] == 1.0
    # Stable content hash.
    assert scene.hash() == Scene(mesh).hash()


def test_camera_signature_roundtrip():
    cam = Camera(
        position=np.array([1.5, -2.25, 3.75], np.float32),
        forward=np.array([0.3, -0.2, -0.9], np.float32),
        up=np.array([0.1, 1.0, 0.05], np.float32),
        fov=45.0,
        near=0.01,
        far=100.0,
        speed=1.25,
        keep_aligned=True,
    )
    sig = cam.encode_signature()
    cam2 = Camera.decode_signature(sig)
    np.testing.assert_array_equal(cam2.position, cam.position)
    assert cam2.fov == np.float32(cam.fov)
    assert cam2.near == np.float32(cam.near)
    assert cam2.far == np.float32(cam.far)
    assert cam2.keep_aligned == cam.keep_aligned
    # Directions survive up to the codec's normalize (ratios are exact).
    np.testing.assert_allclose(
        cam2.forward / np.linalg.norm(cam2.forward),
        cam.forward / np.linalg.norm(cam.forward),
        atol=1e-6,
    )
    # Axis-aligned direction uses the compact face-only form.
    cam3 = Camera.decode_signature(Camera().encode_signature())
    np.testing.assert_array_equal(cam3.forward, [0, 0, -1])


def test_camera_signature_known_alphabet():
    # decodeBits charset: '/'..':' -> 0..11, 'A'..'Z' -> 12..37, 'a'..'z' -> 38..63
    # (reference CameraControls.cc:482-488).
    from tpu_rt.scene.camera import _decode_bits, _encode_bits

    for v in range(64):
        ch = _encode_bits(v)
        got, _ = _decode_bits(ch, 0)
        assert got == v
    assert _encode_bits(0) == "/"
    assert _encode_bits(11) == ":"
    assert _encode_bits(12) == "A"
    assert _encode_bits(38) == "a"


def test_camera_matrices():
    cam = Camera(
        position=np.array([0, 0, 5], np.float32),
        forward=np.array([0, 0, -1], np.float32),
        up=np.array([0, 1, 0], np.float32),
        fov=90.0,
        near=1.0,
        far=100.0,
    )
    w2c = cam.world_to_camera()
    # Looking down -z from (0,0,5): world origin maps to (0,0,-5) in camera.
    np.testing.assert_allclose(w2c @ [0, 0, 0, 1], [0, 0, -5, 1], atol=1e-6)
    # perspective: z=-near -> ndc z=-1, z=-far -> +1.
    p = perspective(90.0, 1.0, 100.0)
    for z, want in [(-1.0, -1.0), (-100.0, 1.0)]:
        clip = p @ [0, 0, z, 1]
        assert np.isclose(clip[2] / clip[3], want, atol=1e-5)
    # fov=90: x=|z| maps to ndc x=+-1.
    clip = p @ [2.0, 0, -2.0, 1]
    assert np.isclose(clip[0] / clip[3], 1.0, atol=1e-6)


def test_nscreen_to_world_center_ray():
    cam = Camera.for_bbox([-1, -1, -1], [1, 1, 1])
    m = cam.nscreen_to_world(640, 480)
    center = m @ np.array([0.0, 0.0, 0.0, 1.0], np.float32)
    world = center[:3] / center[3]
    d = world - cam.position
    d = d / np.linalg.norm(d)
    np.testing.assert_allclose(d, [0, 0, -1], atol=1e-5)


def test_fit_to_view_letterbox():
    m = fit_to_view((-1, -1), (2, 2), (640, 480))
    # 640x480: x scaled by 0.75, y by 1.0 (aspect letterbox).
    np.testing.assert_allclose(np.diag(m), [0.75, 1.0, 1.0, 1.0], atol=1e-6)
    np.testing.assert_allclose(m[:3, 3], 0.0, atol=1e-6)


def test_procedural_counts():
    m = procedural.make_blob(5000, seed=4)
    assert m.num_triangles == 5000
    m = procedural.make_interior(8000, seed=4)
    assert m.num_triangles == 8000
    m = procedural.make_hairball(4000, seed=4)
    assert m.num_triangles == 4000
    # Scenes are watertight enough for tracing: all indices valid.
    idx = m.flat_indices()
    assert idx.min() >= 0 and idx.max() < m.num_vertices


def test_procedural_deterministic():
    a = procedural.make_blob(2000, seed=7)
    b = procedural.make_blob(2000, seed=7)
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(a.flat_indices(), b.flat_indices())


def test_mesh_clean_removes_degenerates_and_unused():
    from tpu_rt.scene.objio import Material, Mesh
    import numpy as np

    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [5, 5, 5]], np.float32)
    subs = [np.array([[0, 1, 2], [0, 0, 2]], np.int32),
            np.array([[1, 1, 1]], np.int32)]
    mesh = Mesh(pos, None, None, subs, [Material(), Material()])
    mesh.clean()
    assert len(mesh.submeshes) == 1          # empty submesh dropped
    assert mesh.submeshes[0].shape == (1, 3)  # degenerate tris dropped
    assert mesh.num_vertices == 3             # vertex 3 unreferenced
    np.testing.assert_array_equal(mesh.submeshes[0], [[0, 1, 2]])


def test_mesh_collapse_vertices_merges_identical():
    from tpu_rt.scene.objio import Material, Mesh
    import numpy as np

    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0],
                    [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    subs = [np.array([[0, 1, 2], [3, 5, 4]], np.int32)]
    mesh = Mesh(pos, None, None, subs, [Material()])
    mesh.collapse_vertices()
    assert mesh.num_vertices == 4
    assert mesh.num_triangles == 2
    # Shared edge now uses the same vertex ids in both triangles.
    a, b = mesh.submeshes[0]
    assert len(set(a.tolist()) & set(b.tolist())) == 2


def test_mesh_simplify_bounded_drift():
    from tpu_rt.scene.objio import Material, Mesh
    import numpy as np

    # A finely tessellated unit square; a small error budget must reduce
    # triangle count without letting any vertex drift beyond the budget.
    n = 17
    g = np.linspace(0, 1, n, dtype=np.float32)
    gx, gy = np.meshgrid(g, g, indexing="ij")
    pos = np.stack([gx.ravel(), gy.ravel(), np.zeros(n * n, np.float32)], 1)
    tris = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            tris.append([a, a + 1, a + n])
            tris.append([a + 1, a + n + 1, a + n])
    mesh = Mesh(pos.copy(), None, None,
                [np.array(tris, np.int32)], [Material()])
    before = mesh.num_triangles
    mesh.simplify(0.08)
    assert 0 < mesh.num_triangles < before
    # Drift bound: every surviving vertex stays within max_error of some
    # original vertex (triangle-inequality bound the method guarantees).
    d = np.linalg.norm(mesh.positions[:, None, :] - pos[None, :, :], axis=2)
    assert float(d.min(axis=1).max()) <= 0.08 + 1e-5


def _mesh_equal(a, b):
    assert a.num_vertices == b.num_vertices
    np.testing.assert_array_equal(a.positions, b.positions)
    assert (a.normals is None) == (b.normals is None)
    if a.normals is not None:
        np.testing.assert_array_equal(a.normals, b.normals)
    assert (a.texcoords is None) == (b.texcoords is None)
    if a.texcoords is not None:
        np.testing.assert_array_equal(a.texcoords, b.texcoords)
    assert len(a.submeshes) == len(b.submeshes)
    for sa, sb in zip(a.submeshes, b.submeshes):
        np.testing.assert_array_equal(sa, sb)
    for ma, mb in zip(a.materials, b.materials):
        assert ma.name == mb.name
        np.testing.assert_allclose(ma.diffuse, mb.diffuse)


def test_obj_numpy_engine_matches_scalar(obj_path):
    """The vectorized token-array importer is bit-identical to the scalar
    line-loop oracle: same welding order, submesh order, triangulation."""
    a = import_wavefront_mesh(obj_path, engine="numpy")
    b = import_wavefront_mesh(obj_path, engine="scalar")
    _mesh_equal(a, b)


def test_obj_import_large_roundtrip(tmp_path):
    """>=500K-tri export -> import round trip within a time budget
    (the reference ingests hairball-class OBJs,
    MeshWavefrontIO.cc:449-469; the importer must scale)."""
    import time

    mesh = procedural.make_blob(500_000, seed=3)
    assert mesh.num_triangles >= 500_000
    out = str(tmp_path / "big.obj")
    export_wavefront_mesh(mesh, out)
    t0 = time.perf_counter()
    back = import_wavefront_mesh(out, engine="numpy")
    dt = time.perf_counter() - t0
    assert back.num_triangles == mesh.num_triangles
    assert back.num_vertices == mesh.num_vertices
    # Vertex order after welding is first-reference order, not file
    # order; compare per-triangle geometry instead.
    np.testing.assert_allclose(
        back.positions[back.flat_indices()],
        mesh.positions[mesh.flat_indices()], atol=2e-6, rtol=1e-5)
    # Budget: vectorized parse is seconds for 1M-tri-class files (the
    # scalar loop is minutes).  Generous bound for slow CI hosts.
    assert dt < 60.0, f"large OBJ import took {dt:.1f}s"
