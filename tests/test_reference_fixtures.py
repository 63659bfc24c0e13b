"""Regression locks against the reference repo's real fixtures.

1. Every camera signature in /root/reference/grtcmdline.txt decodes and
   re-encodes through the codec (CameraControls.cc:354-420,473-554).
   Float fields are exact 36-bit IEEE encodings so they roundtrip
   bit-for-bit; directions are face + 2 f32 ratios recomputed from the
   *normalized* decoded vector (CameraControls.cc:512-554), so a 1-ulp
   ratio wobble can flip one low-order chunk — the reference's own
   encoder has the same property.  We pin the exact-match count and
   require field-level agreement for all.
2. A decoded reference camera drives a full frame end-to-end.
3. SBVH build statistics for the procedural suite are pinned exactly so
   builder drift is caught (the reference pins real-scene counts in
   README.md:46-58; the surrogates stand in for the non-redistributable
   OBJ files).
"""

import os
import re

import numpy as np
import pytest

from tpu_rt.bvh import load_or_build_bvh
from tpu_rt.renderer import Renderer, RendererParams
from tpu_rt.scene import Camera, Scene, procedural

GRTCMDLINE = "/root/reference/grtcmdline.txt"

pytestmark = pytest.mark.skipif(
    not os.path.exists(GRTCMDLINE), reason="reference fixtures not present")


def _signatures():
    sigs = []
    for line in open(GRTCMDLINE):
        m = re.search(r'--camera="([^"]+)"', line)
        if m:
            sigs.append(m.group(1))
    return sigs


def _strip(sig: str) -> str:
    return sig.strip().strip(",").strip('"')


def test_grtcmdline_signatures_decode_and_reencode():
    sigs = _signatures()
    assert len(sigs) == 27
    exact = 0
    for s in sigs:
        cam = Camera.decode_signature(s)
        # Encoded format matches the reference: quoted + trailing comma
        # (CameraControls.cc:357,368).
        enc = cam.encode_signature()
        assert enc.startswith('"') and enc.endswith('",')
        e1 = _strip(enc)
        exact += e1 == s
        # Field-level roundtrip: bit-coded floats exact, directions to
        # normalize/ratio rounding.
        cam2 = Camera.decode_signature(e1)
        assert cam2.position == pytest.approx(cam.position, abs=0)
        assert cam2.fov == cam.fov and cam2.near == cam.near
        assert cam2.far == cam.far
        np.testing.assert_allclose(cam2.forward, cam.forward, atol=2e-7)
        np.testing.assert_allclose(cam2.up, cam.up, atol=2e-7)
    # 20/27 reference strings reproduce char-for-char; the rest differ by
    # one low-order direction chunk (see module docstring).  Pin it.
    assert exact == 20


def test_decoded_reference_camera_renders_frame(tmp_path):
    # The Mori Knob line (grtcmdline.txt): the procedural knob surrogate
    # shares the real scene's near-origin bbox, so the decoded camera
    # actually sees it.
    sig = "OaNay1BnAHz/aNatz11feeey/BnAny18///m007toC10BnAHx///Uy200"
    cam = Camera.decode_signature(sig)
    assert cam.far == 500.0
    scene = Scene(procedural.scene_by_name("knob"))
    r = Renderer(64, 48, RendererParams(ray_type="primary",
                                        cache_dir=str(tmp_path)))
    r.set_scene(scene)
    stats = r.render_frame(cam)
    assert stats["rays_traced"] == 64 * 48
    img = r.update_result()
    assert img.shape == (48, 64, 4)
    # Visibility lock: the decoded camera frames the model (most of the
    # 64x48 frame covers geometry — blob + ground plane — when decoding
    # is correct; a broken decode points the camera into empty space).
    assert r.primary.hits is not None
    tri = np.asarray(r.primary.hits.tri)
    frac = float((tri >= 0).mean())
    assert 0.6 < frac < 0.95, frac


# Pinned SBVH build stats (sah_cost rounded to 6 digits).  These catch
# builder drift the way the reference's README node/tri counts do.
_PINNED = {
    # knob includes its ground plane (reference Mori Knob is an
    # object-on-plane scene; see procedural.make_blob ground=True).
    "knob": dict(num_inner_nodes=4234, num_leaf_nodes=4235,
                 refs=12571, num_duplicates=1, sah=3.802043),
    "sponza": dict(num_inner_nodes=39412, num_leaf_nodes=39413,
                   refs=123243, num_duplicates=1859, sah=6.970194),
}


@pytest.mark.parametrize("name", sorted(_PINNED))
def test_sbvh_build_stats_pinned(name, tmp_path):
    scene = Scene(procedural.scene_by_name(name))
    flat, stats = load_or_build_bvh(scene, cache_dir=str(tmp_path))
    want = _PINNED[name]
    assert stats.num_inner_nodes == want["num_inner_nodes"]
    assert stats.num_leaf_nodes == want["num_leaf_nodes"]
    assert int(np.asarray(flat.tri_woop).shape[0]) == want["refs"]
    assert stats.num_duplicates == want["num_duplicates"]
    assert stats.sah_cost == pytest.approx(want["sah"], abs=5e-6)


def test_grt_replay_parses_every_line():
    """Drop-in CLI compatibility: every replayable line
    of the reference cookbook parses through the real parser with its
    camera decoding; scenes with surrogates remap, the three scenes
    without one (cornellbox/breakfast_room/gallery) fail loudly."""
    from tpu_rt.bench.cli import (GRT_SURROGATES, apply_grt, build_parser,
                                  grt_flag_lines)

    parser = build_parser()
    lines = grt_flag_lines(GRTCMDLINE)
    assert len(lines) == 27
    mapped = unmapped = 0
    for i in range(1, len(lines) + 1):
        base = ["--grt-file", GRTCMDLINE, "--grt-line", str(i)]
        args = parser.parse_args(base)
        try:
            out = apply_grt(parser, args, base)
        except SystemExit as e:
            assert "no procedural surrogate" in str(e)
            unmapped += 1
            continue
        mapped += 1
        assert out.mesh is None and out.scene in GRT_SURROGATES.values()
        assert out.camera, f"line {i} lost its camera"
        cam = Camera.decode_signature(out.camera[0])
        assert np.all(np.isfinite(cam.position))
        # The cookbook uses 1.0e-5 everywhere except three 1.0e-6 lines.
        assert out.sbvh_alpha in (pytest.approx(1.0e-5),
                                  pytest.approx(1.0e-6))
    assert mapped == 24 and unmapped == 3


def test_grt_replay_smoke_render():
    """One cookbook line renders end-to-end through the CLI (the knob
    line — smallest scene), with user flags overriding frame size and
    repeats."""
    from tpu_rt.bench import cli

    lines = cli.grt_flag_lines(GRTCMDLINE)
    knob_line = next(i for i, ln in enumerate(lines, 1) if "testObj" in ln)
    rc = cli.main([
        "--grt-file", GRTCMDLINE, "--grt-line", str(knob_line),
        "--size", "48x36", "--warmup-repeats", "0",
        "--measure-repeats", "1", "--tracer", "xla", "--cache-dir", "",
    ])
    assert rc == 0


def test_grt_replay_user_override_precedence():
    """User scalar flags override the cookbook line; the line's camera
    remains the replay camera."""
    from tpu_rt.bench.cli import apply_grt, build_parser

    parser = build_parser()
    base = ["--grt-file", GRTCMDLINE, "--grt-line", "1",
            "--size", "64x48", "--ray-type", "ao"]
    args = apply_grt(parser, parser.parse_args(base), base)
    assert args.size == "64x48" and args.ray_type == "ao"
    assert args.scene == "conference"
    assert args.camera[0].startswith("6omr/")
    assert args.ao_radius == 5.0
