"""Port Viewer.render_frame vs the JAX Viewer, and the port's CLI on the CPU."""

import json
import os

import numpy as np
import pytest

from gaussian_splat_tpu.camera import Camera as JaxCamera
from gaussian_splat_tpu.models.gaussians import GaussianModel as JaxModel
from gaussian_splat_tpu.viewer.viewer import Viewer as JaxViewer
from gaussian_splat_tpu_torch import cli, convert
from gaussian_splat_tpu_torch.utils.timing import ScopeTimer
from gaussian_splat_tpu_torch.viewer.trackball import TrackballCamera
from gaussian_splat_tpu_torch.viewer.viewer import Viewer, to_uint8

PLY = os.path.join(os.path.dirname(__file__), "golden", "scene.ply")
W, H = 96, 64


@pytest.fixture(scope="module")
def viewers():
    leaves = convert.random_leaves(0, 120, sh_degree=1, extent=1.2, scale_range=(0.02, 0.1))
    jv = JaxViewer(JaxModel.create(**leaves), width=W, height=H, show_overlay=False)
    tv = Viewer(
        convert.model_from_numpy(leaves, "cpu"), width=W, height=H,
        show_overlay=False, device="cpu",
    )
    jc = JaxCamera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, W, H)
    tc = convert.camera_from_numpy(
        np.asarray(jc.viewmat), jc.fx, jc.fy, jc.cx, jc.cy, W, H, device="cpu"
    )
    return jv, jc, tv, tc


@pytest.mark.parametrize("mode", ["color", "alpha", "depth"])
def test_render_frame_matches_jax_viewer(viewers, mode):
    jv, jc, tv, tc = viewers
    jv.mode = tv.mode = mode
    want = jv.render_frame(jc)
    got = tv.render_frame(tc)
    assert got.dtype == np.uint8 and got.shape == (H, W, 3)
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
    assert got.max() > 50  # not a blank frame


def test_trackball_camera_and_metrics(viewers):
    jv, _, tv, _ = viewers
    tv.mode = jv.mode = "color"
    for tb in (tv.trackball, jv.trackball):
        tb.handle_mouse_down(10, 10, 0)
        tb.handle_mouse_move(40, 25, H)
        tb.handle_mouse_up()
        tb.handle_scroll(2.0)
    np.testing.assert_allclose(tv.trackball.position, jv.trackball.position)
    got, want = tv.render_frame(), jv.render_frame()
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
    m = tv.metrics()
    assert m["num_gaussians"] == 120 and m["resolution"] == [W, H] and m["frame_ms"] > 0
    assert int(tv.last_stats.overflow) == 0
    tv.resize(8, 2000)
    assert (tv.width, tv.height) == (16, 2000)
    tv.resize(W, H)
    assert TrackballCamera().camera(32, 16, device="cpu").width == 32


def test_turntable_and_to_uint8(viewers, tmp_path):
    _, _, tv, _ = viewers
    frames = tv.orbit_turntable(n_frames=2, radius=4.0, out_dir=str(tmp_path / "tt"))
    assert len(frames) == 2 and sorted(os.listdir(tmp_path / "tt")) == [
        "frame_0000.png", "frame_0001.png"
    ]
    import torch

    x = torch.tensor([[-1.0, 0.0, 0.5, 1.0, 2.0]])
    assert to_uint8(x).tolist() == [[0, 0, 128, 255, 255]]


def test_later_slices_raise(viewers):
    """Nothing raises for want of a later slice any more: the viewer takes the
    overlay, both LoDs and `serve()`, and the trainer takes `mesh=` (the
    multi-GPU slice; the step renders through render_sharded when called)."""
    from gaussian_splat_tpu_torch.config import TrainConfig
    from gaussian_splat_tpu_torch.train.trainer import make_train_step

    _, _, tv, tc = viewers
    model = tv.model
    for kw in (dict(show_overlay=True), dict(show_overlay=False, lod_fraction=0.5),
               dict(show_overlay=False, lod_pair_budget=0.5)):
        v = Viewer(model, device="cpu", width=W, height=H, **kw)
        assert v.render_frame().shape == (H, W, 3)
    server = tv.serve(port=0, block=False)
    server.shutdown()
    server.server_close()
    assert callable(make_train_step(tc, tv.config, TrainConfig(), mesh=object()))


def test_scope_timer_records():
    t = ScopeTimer("cpu")
    for _ in range(3):
        with t.scope("a"):
            pass
    assert len(t.stats["a"]) == 3 and t.stats["a"].median >= 0 and "a" in t.report()


def test_cli_render_writes_png(tmp_path, capsys):
    out = tmp_path / "out.png"
    rc = cli.main([
        "render", PLY, "--out", str(out), "--width", "96", "--height", "64",
        "--radius", "3.0", "--device", "cpu",
    ])
    assert rc == 0 and out.stat().st_size > 500
    from PIL import Image

    img = np.asarray(Image.open(out))
    assert img.shape == (64, 96, 3) and img.max() > 50
    assert "2000 splats on cpu" in capsys.readouterr().out


def test_cli_info_and_turntable(tmp_path, capsys):
    assert cli.main(["info", PLY, "--device", "cpu"]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["num_gaussians"] == 2000 and stats["sh_degree"] == 0
    rc = cli.main([
        "turntable", PLY, "--out-dir", str(tmp_path / "tt"), "--frames", "2",
        "--width", "64", "--height", "48", "--device", "cpu",
    ])
    assert rc == 0 and len(os.listdir(tmp_path / "tt")) == 2
