"""Port PLY reader vs the JAX reader, and the port's render vs the golden image."""

import os

import numpy as np
import pytest

from gaussian_splat_tpu.io import ply as jax_ply
from gaussian_splat_tpu_torch.camera import Camera
from gaussian_splat_tpu_torch.config import RenderConfig
from gaussian_splat_tpu_torch.io import ply as torch_ply
from gaussian_splat_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_tpu_torch.ops.render import render

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
PLY = os.path.join(GOLDEN_DIR, "scene.ply")
NPY = os.path.join(GOLDEN_DIR, "golden.npy")


def test_read_ply_equals_jax_reader():
    want = jax_ply.read_ply(PLY, use_native=False)
    got = torch_ply.read_ply(PLY)
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])


def test_load_gaussians_leaves_equal_jax():
    jm = jax_ply.load_gaussians(PLY)
    tm = torch_ply.load_gaussians(PLY, device="cpu")
    assert tm.num_gaussians == jm.num_gaussians == 2000
    assert tm.sh_degree == jm.sh_degree
    for name in GaussianModel.LEAVES:
        np.testing.assert_array_equal(
            getattr(tm, name).detach().numpy(), np.asarray(getattr(jm, name)), name
        )


@pytest.mark.parametrize("backend", ["torch_tile", "reference"])
def test_render_matches_golden(backend):
    golden = np.load(NPY).astype(np.float32)
    model = torch_ply.load_gaussians(PLY, device="cpu")
    cam = Camera.from_lookat(
        (0.0, 1.2, -2.6), (0, 0, 0), (0, 1, 0), 50.0, 160, 120, device="cpu"
    )
    cfg = RenderConfig(backend=backend, background=(0.05, 0.05, 0.08))
    img = render(model, cam, cfg).image.detach().numpy()
    assert np.abs(img - golden).max() < 2e-3


def test_ascii_and_mixed_dtype_ply(tmp_path):
    path = tmp_path / "tiny.ply"
    path.write_text(
        "ply\nformat ascii 1.0\nelement vertex 2\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n0 0 0 255 0 0\n1 2 3 0 128 255\n"
    )
    tm = torch_ply.load_gaussians(str(path), device="cpu")
    jm = jax_ply.load_gaussians(str(path))
    for name in GaussianModel.LEAVES:
        np.testing.assert_allclose(
            getattr(tm, name).detach().numpy(), np.asarray(getattr(jm, name)),
            atol=1e-6, err_msg=name,
        )
    bad = tmp_path / "bad.ply"
    bad.write_text("not a ply\n")
    with pytest.raises(ValueError):
        torch_ply.read_ply(str(bad))
