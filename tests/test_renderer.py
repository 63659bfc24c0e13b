"""End-to-end frame tests: the minimum slice of SURVEY.md section 7 step 3 —
procedural knob scene, primary rays, image vs the scalar CPU oracle."""

import numpy as np
import pytest

from tpu_rt.core.math import from_abgr, pixel_morton_luts
from tpu_rt.renderer import Renderer, RendererParams
from tpu_rt.scene import Camera, Scene, procedural
from tpu_rt.shade.reconstruct import BG_COLOR
from tpu_rt.trace import trace_flat_scalar

W, H = 48, 36


@pytest.fixture(scope="module")
def knob():
    mesh = procedural.make_blob(800, seed=30)
    scene = Scene(mesh)
    lo, hi = scene.bbox()
    camera = Camera.for_bbox(lo, hi)
    return mesh, scene, camera


def _reference_primary_image(scene, flat, camera, w, h):
    """Oracle image: scalar-traced primary rays + numpy reconstruct."""
    m = camera.nscreen_to_world(w, h)
    px, py = np.meshgrid(np.arange(w), np.arange(h))
    sx = 2.0 * (px.ravel() + 0.5) / w - 1.0
    sy = 2.0 * (py.ravel() + 0.5) / h - 1.0
    ns = np.stack([sx, sy, np.zeros_like(sx), np.ones_like(sx)], axis=1).astype(np.float32)
    world = ns @ m.T
    wp = world[:, :3] / world[:, 3:4]
    d = wp - camera.position
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.tile(camera.position, (w * h, 1)).astype(np.float32)
    tri, t, _, _ = trace_flat_scalar(
        flat, o, d.astype(np.float32), np.zeros(w * h, np.float32), np.full(w * h, camera.far, np.float32)
    )
    img = np.where(
        (tri >= 0)[:, None],
        scene.tri_shaded[np.clip(tri, 0, scene.num_triangles - 1)],
        BG_COLOR[None, :],
    )
    return img.reshape(h, w, 4), tri.reshape(h, w)


def test_primary_frame_matches_oracle(knob, tmp_path):
    mesh, scene, camera = knob
    r = Renderer(W, H, RendererParams(ray_type="primary", cache_dir=str(tmp_path)))
    r.set_scene(scene)
    stats = r.render_frame(camera)
    assert stats["rays_traced"] == W * H
    img = r.update_result()
    assert img.shape == (H, W, 4)

    ref_img, ref_tri = _reference_primary_image(scene, r.flat, camera, W, H)
    # Pixel-exact hit classification except potential boundary-grazing pixels.
    got_bg = np.all(img == BG_COLOR, axis=-1)
    want_bg = ref_tri == -1
    assert (got_bg == want_bg).mean() > 0.995
    same = got_bg == want_bg
    np.testing.assert_allclose(img[same], ref_img[same], atol=2e-3)
    # The model actually appears in frame.
    assert 0.05 < (~want_bg).mean() < 0.95


def test_primary_frame_deterministic(knob, tmp_path):
    mesh, scene, camera = knob
    r = Renderer(W, H, RendererParams(ray_type="primary", cache_dir=None))
    r.set_scene(scene)
    r.render_frame(camera)
    img1 = r.update_result()
    r.render_frame(camera)
    img2 = r.update_result()
    np.testing.assert_array_equal(img1, img2)


@pytest.mark.parametrize("ray_type", ["ao", "diffuse"])
def test_secondary_frames(knob, ray_type, tmp_path):
    mesh, scene, camera = knob
    params = RendererParams(
        ray_type=ray_type, num_samples=4, ao_radius=3.0, sort_secondary=True,
        max_batch=1 << 12, cache_dir=None, seed=7,
    )
    r = Renderer(W, H, params)
    r.set_scene(scene)
    stats = r.render_frame(camera)
    # Multiple batches were needed (max_batch 4096 < W*H*S).
    assert len(r._batches) > 1
    assert stats["rays_traced"] == W * H * 4
    img = r.update_result()
    assert img.shape == (H, W, 4)
    assert np.isfinite(img).all()

    # Per-phase profiling: raygen/sort/trace all ran and were timed
    # (device Morton sort is in the frame path when sort_secondary).
    ph = stats["phase_s"]
    assert ph["raygen"] > 0 and ph["sort"] > 0 and ph["trace"] > 0
    assert r.phase_s["reconstruct"] > 0  # update_result above

    # Primary misses show the background.
    primary_tri = np.asarray(r.primary.hits.tri)
    pix = np.asarray(r.primary.slot_to_id)
    img_flat = img.reshape(-1, 4)
    miss_px = pix[primary_tri == -1]
    np.testing.assert_allclose(
        img_flat[miss_px], np.broadcast_to(BG_COLOR, (miss_px.size, 4)), atol=1e-6
    )

    hit_px = pix[primary_tri >= 0]
    hit_colors = img_flat[hit_px]
    if ray_type == "ao":
        # AO pixels are grayscale in [0,1]: mean of white (miss) and black
        # (blocked) samples.
        assert np.all(hit_colors[:, 0] == hit_colors[:, 1])
        assert hit_colors[:, :3].min() >= 0.0 and hit_colors[:, :3].max() <= 1.0
        # The blob occludes itself somewhere.
        assert (hit_colors[:, 0] < 1.0).any()
    else:
        # Diffuse modulates by material color; alpha stays 1.
        np.testing.assert_allclose(hit_colors[:, 3], 1.0, atol=1e-6)


def test_mrays_metric_formula(knob):
    """Pin the Mray/s formula to the reference definition
    (App.cc:188-204 + Renderer.cc:221-238): numerator = primary count for
    primary, primary HITS x num_samples for secondary — not rays_traced
    (which counts degenerate miss rays and would inflate the rate)."""
    mesh, scene, camera = knob
    r = Renderer(W, H, RendererParams(ray_type="ao", num_samples=2,
                                      ao_radius=3.0, cache_dir=None))
    r.set_scene(scene)
    stats = r.render_frame(camera)
    n_hits = int(np.sum(np.asarray(r.primary.hits.tri) >= 0))
    assert stats["total_rays"] == n_hits * 2
    # The blob does not fill the frame: some primaries miss, so traced
    # rays (hits+misses x samples) strictly exceed the metric numerator.
    assert stats["rays_traced"] == W * H * 2 > stats["total_rays"] > 0
    expect = stats["total_rays"] / (stats["trace_time_s"] * 1e6)
    assert stats["mrays_per_s"] == pytest.approx(expect)

    r2 = Renderer(W, H, RendererParams(ray_type="primary", cache_dir=None))
    r2.set_scene(scene)
    stats2 = r2.render_frame(camera)
    assert stats2["total_rays"] == W * H == stats2["rays_traced"]


def test_secondary_sort_invariance(knob):
    # Morton-sorting the secondary batch must not change the image.
    mesh, scene, camera = knob
    imgs = []
    for sort in (False, True):
        params = RendererParams(
            ray_type="ao", num_samples=2, ao_radius=3.0, sort_secondary=sort,
            cache_dir=None, seed=3,
        )
        r = Renderer(W, H, params)
        r.set_scene(scene)
        r.render_frame(camera)
        imgs.append(r.update_result())
    np.testing.assert_array_equal(imgs[0], imgs[1])


def test_ao_seed_sensitivity(knob):
    mesh, scene, camera = knob
    out = []
    for seed in (0, 1):
        r = Renderer(W, H, RendererParams(ray_type="ao", num_samples=2, ao_radius=3.0, cache_dir=None, seed=seed))
        r.set_scene(scene)
        r.render_frame(camera)
        out.append(r.update_result())
    assert not np.array_equal(out[0], out[1])  # rotation angles depend on seed


def test_compact_degenerate_matches_default(knob, tmp_path):
    """Opt-in dead-ray compaction (dynamic-fetch analogue, SURVEY §2.3
    row 3): dead-last sort + live-prefix trace must produce the same
    image as the default full-batch path."""
    mesh, scene, camera = knob
    imgs = []
    for compact in (False, True):
        params = RendererParams(
            ray_type="ao", num_samples=2, ao_radius=3.0,
            sort_secondary=True, max_batch=1 << 12, cache_dir=None,
            seed=7, compact_degenerate=compact,
        )
        r = Renderer(W, H, params)
        r.set_scene(scene)
        r.render_frame(camera)
        imgs.append(r.update_result())
    np.testing.assert_array_equal(imgs[0], imgs[1])


def test_tracer_choice(knob):
    """Tracer choice: 'auto' resolves to the XLA tracer without a GPU and
    says so; asking for the CUDA kernel without a GPU raises instead of
    falling back quietly; an unknown tracer name raises."""
    from tpu_rt.bvh import build_sbvh, flatten_bvh
    from tpu_rt.trace import make_routing_tracer

    mesh, scene, camera = knob
    flat = flatten_bvh(build_sbvh(scene), scene.tri_vtx_index, scene.vtx_pos)
    fn, kind, tables = make_routing_tracer(flat, prefer="auto")
    assert kind == "xla"

    # Renderer path.
    r = Renderer(W, H, RendererParams(cache_dir=None, tracer="auto"))
    r.set_scene(scene)
    r._ensure_bvh()
    assert r.active_tracer == "xla"
    for choice, err in (("cuda", RuntimeError), ("pallas", ValueError)):
        r = Renderer(W, H, RendererParams(cache_dir=None, tracer=choice))
        r.set_scene(scene)
        with pytest.raises(err):
            r._ensure_bvh()
    with pytest.raises(RuntimeError, match="GPU backend"):
        make_routing_tracer(flat, prefer="cuda")


@pytest.mark.parametrize("live,n,expect", [
    (0, 4096, 0), (1, 4096, 512), (512, 4096, 512), (513, 4096, 1024),
    (4096, 4096, 4096), (5000, 4096, 4096), (3, 10, 4),
])
def test_live_prefix_len_buckets(live, n, expect):
    """The live prefix is rounded up to one of LIVE_BUCKETS sizes per
    batch, so compaction compiles the tracer a bounded number of times."""
    from tpu_rt.rays.buffer import LIVE_BUCKETS, live_prefix_len

    m = live_prefix_len(live, n)
    assert m == expect
    assert live <= m or m == n
    step = -(-n // LIVE_BUCKETS)
    assert m == n or m % step == 0
