"""Port Camera / GaussianModel / convert vs their JAX counterparts."""

import numpy as np
import pytest
import torch

from gaussian_splat_tpu import camera as jax_camera
from gaussian_splat_tpu.models.gaussians import GaussianModel as JaxModel
from gaussian_splat_tpu_torch import camera as torch_camera
from gaussian_splat_tpu_torch import convert
from gaussian_splat_tpu_torch.models.gaussians import GaussianModel as TorchModel


def _assert_camera_close(tc, jc, atol=1e-6):
    np.testing.assert_allclose(tc.viewmat.numpy(), np.asarray(jc.viewmat), atol=atol)
    for name in ("fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(
            float(getattr(tc, name)), float(getattr(jc, name)), rtol=1e-6
        )
    assert (tc.width, tc.height) == (jc.width, jc.height)


@pytest.mark.parametrize("eye,target,up", [
    ((0.0, 0.5, -5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)),
    ((1.5, -0.7, 2.0), (0.2, 0.1, -0.3), (0.0, 1.0, 0.0)),
    ((0.0, 1.2, -2.6), (0.0, 0.0, 0.0), (0.3, 1.0, 0.1)),
])
def test_look_at_and_from_lookat(eye, target, up):
    np.testing.assert_allclose(
        torch_camera.look_at(eye, target, up).numpy(),
        np.asarray(jax_camera.look_at(eye, target, up)), atol=1e-6,
    )
    tc = torch_camera.Camera.from_lookat(eye, target, up, 50.0, 160, 120, device="cpu")
    jc = jax_camera.Camera.from_lookat(eye, target, up, 50.0, 160, 120)
    _assert_camera_close(tc, jc)
    np.testing.assert_allclose(tc.position.numpy(), np.asarray(jc.position), atol=1e-6)
    np.testing.assert_allclose(tc.rotation.numpy(), np.asarray(jc.rotation), atol=1e-6)
    np.testing.assert_allclose(
        tc.translation.numpy(), np.asarray(jc.translation), atol=1e-6
    )


@pytest.mark.parametrize("az,el", [(0.0, 20.0), (135.0, -10.0), (300.0, 45.0)])
def test_orbit_camera_and_resized(az, el):
    tc = torch_camera.orbit_camera(5.0, az, el, width=128, height=96, device="cpu")
    jc = jax_camera.orbit_camera(5.0, az, el, width=128, height=96)
    _assert_camera_close(tc, jc)
    _assert_camera_close(tc.resized(96, 64), jc.resized(96, 64))


def test_camera_from_numpy_is_exact():
    jc = jax_camera.Camera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, 96, 64)
    tc = convert.camera_from_numpy(
        np.asarray(jc.viewmat), np.asarray(jc.fx), np.asarray(jc.fy),
        np.asarray(jc.cx), np.asarray(jc.cy), jc.width, jc.height, device="cpu",
    )
    _assert_camera_close(tc, jc, atol=0.0)
    assert tc.to("cpu").viewmat.device.type == "cpu"


def test_model_from_numpy_round_trips_and_activations_match():
    leaves = convert.random_leaves(3, 50, sh_degree=2)
    tm = convert.model_from_numpy(leaves, device="cpu")
    jm = JaxModel.create(**leaves)
    for name in TorchModel.LEAVES:
        back = getattr(tm, name).detach().numpy()
        np.testing.assert_array_equal(back, leaves[name])
        np.testing.assert_array_equal(back, np.asarray(getattr(jm, name)))
        assert isinstance(getattr(tm, name), torch.nn.Parameter)
    assert tm.num_gaussians == jm.num_gaussians == 50
    assert tm.sh_degree == jm.sh_degree == 2
    np.testing.assert_allclose(
        tm.scales.detach().numpy(), np.asarray(jm.scales), rtol=1e-6
    )
    np.testing.assert_allclose(
        tm.opacities.detach().numpy(), np.asarray(jm.opacities), rtol=1e-6
    )
    with pytest.raises(KeyError):
        convert.model_from_numpy({"means": leaves["means"]}, device="cpu")


def test_random_model_distributions():
    g = torch.Generator().manual_seed(0)
    m = TorchModel.random(
        g, 4000, sh_degree=1, extent=2.0, scale_range=(0.005, 0.02), device="cpu"
    )
    assert m.means.shape == (4000, 3) and m.sh.shape == (4000, 4, 3)
    assert float(m.means.detach().abs().max()) <= 2.0
    np.testing.assert_allclose(
        torch.linalg.norm(m.quats, dim=-1).detach().numpy(), 1.0, atol=1e-5
    )
    s = m.scales.detach()
    assert float(s.min()) >= 0.005 * 0.999 and float(s.max()) <= 0.02 * 1.001
    lo = m.opacity_logits.detach()
    assert -1.0 <= float(lo.min()) and float(lo.max()) <= 3.0
    assert abs(float(lo.mean()) - 1.0) < 0.1
    iso = TorchModel.random(g, 10, isotropic=True, device="cpu")
    assert torch.equal(iso.log_scales[:, 0], iso.log_scales[:, 2])
