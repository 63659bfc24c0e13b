"""Interactive display path (the headless stand-in for the
reference's GL window, App.cc:62-132): HTTP orbit viewer serving
freshly traced frames."""

import threading
import urllib.request

import numpy as np
import pytest

from tpu_rt.bench.viewer import ViewerState, _encode_image, make_server
from tpu_rt.renderer import RendererParams
from tpu_rt.scene import Scene, procedural


@pytest.fixture(scope="module")
def server():
    scene = Scene(procedural.make_blob(400, seed=12))
    state = ViewerState(scene, 64, 48,
                        RendererParams(cache_dir=None, tracer="xla"))
    srv = make_server(state, port=0)  # ephemeral port
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def test_index_page(server):
    body = urllib.request.urlopen(f"{server}/").read()
    assert b"tpu_rt viewer" in body and b"/frame?" in body


def test_frame_renders_and_orbits(server):
    r1 = urllib.request.urlopen(f"{server}/frame?yaw=0&pitch=0.3&dist=1")
    img1 = r1.read()
    assert r1.headers["Content-Type"] in ("image/png", "image/bmp")
    assert float(r1.headers["X-Mrays-Per-S"]) > 0
    # A different orbit angle produces a different image.
    img2 = urllib.request.urlopen(
        f"{server}/frame?yaw=2.0&pitch=0.3&dist=1").read()
    assert img1 != img2
    # Bad query -> 400 with a JSON error, not a crash.
    try:
        urllib.request.urlopen(f"{server}/frame?yaw=zzz")
        raise AssertionError("expected 400")
    except urllib.error.HTTPError as e:
        assert e.code == 400


def test_encode_image_roundtrip():
    img = (np.random.default_rng(0).uniform(0, 255, (8, 10, 3))
           .astype(np.uint8))
    data, ctype = _encode_image(img)
    if ctype == "image/png":
        from PIL import Image
        import io

        back = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(back, img)
    else:
        assert data[:2] == b"BM"
