"""The port's transforms.json I/O against the JAX package's, on the same files."""

import json
import os

import numpy as np
import pytest
import torch

from gaussian_splat_tpu.camera import Camera as JaxCamera
from gaussian_splat_tpu.io import dataset_io as jax_io
from gaussian_splat_tpu.train.dataset import ViewDataset as JaxViewDataset
from gaussian_splat_tpu_torch import convert
from gaussian_splat_tpu_torch.io import dataset_io as torch_io
from gaussian_splat_tpu_torch.train.dataset import ViewDataset


def _views(n_views=3, w=40, h=30, seed=0):
    """(jax views, torch views): orbit cameras and seeded images."""
    rng = np.random.default_rng(seed)
    jviews, tviews = [], []
    for i in range(n_views):
        az = np.radians(360.0 * i / n_views)
        eye = (4.0 * np.sin(az), 1.2, 4.0 * np.cos(az))
        jc = JaxCamera.from_lookat(eye, (0, 0, 0), (0, 1, 0), 50.0, w, h)
        tc = convert.camera_from_numpy(
            np.asarray(jc.viewmat), jc.fx, jc.fy, jc.cx, jc.cy, w, h, device="cpu"
        )
        img = rng.uniform(0.0, 1.0, (h, w, 3)).astype(np.float32)
        jviews.append((jc, img))
        tviews.append((tc, img))
    return jviews, tviews


@pytest.fixture
def saved(tmp_path):
    """The same views saved by each package: (jax dir, torch dir)."""
    jviews, tviews = _views()
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jax_io.save_transforms(str(jdir), JaxViewDataset.from_views(jviews))
    torch_io.save_transforms(str(tdir), ViewDataset.from_views(tviews, device="cpu"))
    return jdir, tdir


def test_save_transforms_writes_what_jax_writes(saved):
    jdir, tdir = saved
    want = json.load(open(jdir / "transforms.json"))
    got = json.load(open(tdir / "transforms.json"))
    assert got == want  # every value, the matrices included
    for fr in want["frames"]:
        assert (tdir / fr["file_path"]).read_bytes() == (jdir / fr["file_path"]).read_bytes()


def _assert_same_dataset(got: ViewDataset, want: JaxViewDataset):
    assert (got.num_views, got.width, got.height) == (want.num_views, want.width, want.height)
    assert got.device.type == "cpu"
    np.testing.assert_allclose(got.viewmats.numpy(), np.asarray(want.viewmats), rtol=0, atol=1e-6)
    for k in ("fx", "fy", "cx", "cy"):
        assert float(getattr(got, k)) == float(getattr(want, k)), k
    np.testing.assert_array_equal(got.images.numpy(), np.asarray(want.images))


@pytest.mark.parametrize("downscale,max_frames", [(1, None), (2, 2), (3, 1)])
def test_load_transforms_matches_jax(saved, downscale, max_frames):
    jdir, _ = saved
    want = jax_io.load_transforms(str(jdir), downscale=downscale, max_frames=max_frames)
    got = torch_io.load_transforms(
        str(jdir / "transforms.json"), downscale=downscale, max_frames=max_frames,
        device="cpu",
    )
    _assert_same_dataset(got, want)
    assert got.width == 40 // downscale


def test_camera_angle_x_fallback_and_per_frame_keys(saved):
    jdir, _ = saved
    meta = json.load(open(jdir / "transforms.json"))
    fx = meta.pop("fl_x")
    for k in ("fl_y", "cx", "cy"):
        meta.pop(k)
    meta["camera_angle_x"] = float(2.0 * np.arctan(0.5 * meta["w"] / fx))
    meta["frames"][0]["fl_x"] = 33.0  # a per-frame key wins over the global one
    with open(jdir / "transforms.json", "w") as f:
        json.dump(meta, f)
    for downscale in (1, 2):
        want = jax_io.load_transforms(str(jdir), downscale=downscale)
        got = torch_io.load_transforms(str(jdir), downscale=downscale, device="cpu")
        _assert_same_dataset(got, want)
    assert float(got.fx) == pytest.approx(33.0 / 2)


def test_c2w_conversion_round_trips():
    rng = np.random.default_rng(1)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    c2w = np.eye(4)
    c2w[:3, :3], c2w[:3, 3] = q, rng.standard_normal(3)
    got = torch_io.c2w_opengl_to_viewmat(c2w)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_io.c2w_opengl_to_viewmat(c2w))


def test_errors_and_device(tmp_path, saved):
    with open(tmp_path / "transforms.json", "w") as f:
        json.dump({"frames": []}, f)
    with pytest.raises(ValueError, match="no frames"):
        torch_io.load_transforms(str(tmp_path), device="cpu")
    jdir, _ = saved
    meta = json.load(open(jdir / "transforms.json"))
    meta.pop("fl_x")
    with open(jdir / "transforms.json", "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="camera_angle_x"):
        torch_io.load_transforms(str(jdir), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            torch_io.load_transforms(str(jdir))
    assert os.path.isdir(jdir / "images")
