"""The port's Viewer with overlay, LoD and resize against the JAX Viewer, and
its MJPEG HTTP server driven over a socket."""

import io
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from gaussian_splat_tpu.config import RenderConfig as JaxConfig
from gaussian_splat_tpu.models.gaussians import GaussianModel as JaxModel
from gaussian_splat_tpu.viewer.viewer import Viewer as JaxViewer
from gaussian_splat_tpu_torch import convert
from gaussian_splat_tpu_torch.config import RenderConfig
from gaussian_splat_tpu_torch.ops import cuda_raster
from gaussian_splat_tpu_torch.viewer import viewer as viewer_mod
from gaussian_splat_tpu_torch.viewer.viewer import Viewer

W, H = 96, 64
TIMEOUT = 60  # seconds, every socket operation


@pytest.fixture(scope="module")
def leaves():
    return convert.random_leaves(2, 300, sh_degree=1, extent=1.5, scale_range=(0.02, 0.3))


def _pair(leaves, **kw):
    jv = JaxViewer(JaxModel.create(**leaves), JaxConfig(backend="jnp_tile"),
                   width=W, height=H, **kw)
    tv = Viewer(convert.model_from_numpy(leaves, "cpu"), RenderConfig(), width=W,
                height=H, device="cpu", **kw)
    return jv, tv


def _close(got, want):
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


@pytest.fixture(scope="module")
def viewers(leaves):
    return _pair(leaves, lod_pair_budget=0.3)


@pytest.mark.parametrize("mode,overlay", [("color", True), ("color", False),
                                          ("depth", True), ("alpha", True)])
def test_frames_match_the_jax_viewer(viewers, mode, overlay):
    jv, tv = viewers
    for v in viewers:
        v.mode, v.show_overlay = mode, overlay
    got = tv.render_frame()
    _close(got, jv.render_frame())
    assert got.max() > 50 and not tv.last_frame_lod
    jv.mode = tv.mode = "color"
    jv.show_overlay = tv.show_overlay = True


def test_resize_matches_the_jax_viewer(viewers):
    jv, tv = viewers
    for v in viewers:
        v.resize(80, 48)
    try:
        got = tv.render_frame()
        assert got.shape == (48, 80, 3)
        _close(got, jv.render_frame())
    finally:
        for v in viewers:
            v.resize(W, H)


@pytest.mark.parametrize("kw", [dict(lod_pair_budget=0.3), dict(lod_fraction=0.25)])
def test_lod_switch_matches_the_jax_viewer(leaves, kw):
    jv, tv = _pair(leaves, show_overlay=False, **kw)
    assert tv._model_lod.num_gaussians == jv._model_lod.num_gaussians < 300
    np.testing.assert_array_equal(tv._model_lod.means.detach().numpy(),
                                  np.asarray(jv._model_lod.means))
    full = tv.render_frame()
    full_pairs = int(tv.last_stats.num_pairs)
    _close(full, jv.render_frame())
    for v in (jv, tv):
        v._interacting_until = time.monotonic() + 30.0
    lod = tv.render_frame()
    assert tv.last_frame_lod and int(tv.last_stats.num_pairs) < full_pairs
    _close(lod, jv.render_frame())
    assert (lod != full).any()


def _get(url):
    with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_serve_over_http(leaves, monkeypatch):
    from PIL import Image

    monkeypatch.setattr(viewer_mod, "INTERACTION_HOLD_S", 30.0)
    tv = Viewer(convert.model_from_numpy(leaves, "cpu"), RenderConfig(), width=W,
                height=H, lod_pair_budget=0.3, device="cpu")
    server = tv.serve(host="127.0.0.1", port=0, block=False)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        status, ctype, body = _get(base + "/")
        assert status == 200 and ctype == "text/html" and b"/frame" in body

        cuda_raster.reset_launch_counts()
        status, ctype, body = _get(base + "/frame")
        assert status == 200 and ctype == "image/jpeg" and body[:3] == b"\xff\xd8\xff"
        frame = np.asarray(Image.open(io.BytesIO(body)))
        assert frame.shape == (H, W, 3)
        assert not tv.last_frame_lod
        full_pairs = int(tv.last_stats.num_pairs)
        assert len(tv.timers.stats["jpeg"]) == 1

        status, ctype, body = _get(base + "/metrics")
        m = json.loads(body)
        assert ctype == "application/json" and m["num_gaussians"] == 300
        assert m["resolution"] == [W, H] and m["frame_ms"] > 0

        status, _, body = _get(base + "/input?kind=down&x=10&y=10&b=0")
        assert status == 204 and body == b""
        _get(base + "/input?kind=move&x=30&y=20")
        _get(base + "/frame")
        assert tv.last_frame_lod and int(tv.last_stats.num_pairs) < full_pairs
        _get(base + "/input?kind=up")

        for query in ("kind=mode&m=depth", "kind=overlay", "kind=resize&w=64&h=40",
                      "kind=scroll&dy=1"):
            assert _get(base + "/input?" + query)[0] == 204
        assert tv.mode == "depth" and not tv.show_overlay and (tv.width, tv.height) == (64, 40)
        frame = np.asarray(Image.open(io.BytesIO(_get(base + "/frame")[2])))
        assert frame.shape == (40, 64, 3)
        assert cuda_raster.launch_counts == dict.fromkeys(cuda_raster.KERNELS, 0)

        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base + "/nothing")
        assert e.value.code == 404
    finally:
        server.shutdown()
        server.server_close()


def test_concurrent_frames_are_serialised(leaves):
    """Frames asked for at once from several threads each render whole: one
    render at a time holds the viewer (its lock)."""
    import threading

    tv = Viewer(convert.model_from_numpy(leaves, "cpu"), RenderConfig(), width=48,
                height=32, show_overlay=False, device="cpu")
    inside, overlap = [0], []
    real = viewer_mod.render

    def watched(*a, **k):
        inside[0] += 1
        overlap.append(inside[0])
        time.sleep(0.01)
        try:
            return real(*a, **k)
        finally:
            inside[0] -= 1

    viewer_mod.render = watched
    try:
        threads = [threading.Thread(target=tv.render_frame) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
    finally:
        viewer_mod.render = real
    assert not any(t.is_alive() for t in threads)
    assert overlap == [1] * 6 and len(tv.timers.stats["frame"]) == 6


def test_viewer_needs_its_device(leaves):
    model = convert.model_from_numpy(leaves, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Viewer(model)
    with pytest.raises(ValueError, match="lies on cpu"):
        Viewer(model, device="meta")
