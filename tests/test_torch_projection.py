"""Port project_gaussians vs JAX project_gaussians, field by field, and the
port's quat_to_rotmat and compute_cov3d vs JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splat_tpu.camera import Camera as JaxCamera
from gaussian_splat_tpu.ops import projection as jax_proj
from gaussian_splat_tpu_torch import convert
from gaussian_splat_tpu_torch.ops import projection as torch_proj


def _both(seed, opacity_aware, n=200, width=128, height=96):
    leaves = convert.random_leaves(seed, n, extent=1.5, scale_range=(0.02, 0.3))
    # some splats behind / beside the camera so every cull fires
    leaves["means"][: n // 10, 2] -= 6.0
    jc = JaxCamera.from_lookat((0, 0.3, -4), (0, 0, 0), (0, 1, 0), 60.0, width, height)
    tc = convert.camera_from_numpy(
        np.asarray(jc.viewmat), np.asarray(jc.fx), np.asarray(jc.fy),
        np.asarray(jc.cx), np.asarray(jc.cy), width, height, device="cpu",
    )
    scales = np.exp(leaves["log_scales"])
    op = 1.0 / (1.0 + np.exp(-leaves["opacity_logits"]))
    op[:5] = 0.002  # below alpha_skip: culled outright when opacity-aware
    kw = dict(opacities=op, alpha_skip=1.0 / 255.0) if opacity_aware else {}
    jp = jax_proj.project_gaussians(
        jnp.asarray(leaves["means"]), jnp.asarray(leaves["quats"]),
        jnp.asarray(scales), jc,
        **{k: (jnp.asarray(v) if k == "opacities" else v) for k, v in kw.items()},
    )
    tp = torch_proj.project_gaussians(
        torch.from_numpy(leaves["means"]), torch.from_numpy(leaves["quats"]),
        torch.from_numpy(scales), tc,
        **{k: (torch.from_numpy(v) if k == "opacities" else v) for k, v in kw.items()},
    )
    return jp, tp


@pytest.mark.parametrize("opacity_aware", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_projection_fields_match_jax(seed, opacity_aware):
    jp, tp = _both(seed, opacity_aware)
    valid = np.asarray(jp.valid)
    assert 0 < valid.sum() < valid.size
    np.testing.assert_array_equal(tp.valid.numpy(), valid)
    np.testing.assert_array_equal(tp.radii.numpy(), np.asarray(jp.radii))
    assert tp.radii.dtype == torch.int32
    np.testing.assert_allclose(
        tp.means2d.numpy()[valid], np.asarray(jp.means2d)[valid], atol=1e-4, rtol=1e-5
    )
    for name in ("conics", "depths", "cov2d", "compensation", "extents"):
        np.testing.assert_allclose(
            getattr(tp, name).numpy()[valid], np.asarray(getattr(jp, name))[valid],
            atol=1e-4, rtol=1e-5, err_msg=name,
        )


def test_view_directions_match_jax():
    leaves = convert.random_leaves(2, 40)
    jc = JaxCamera.from_lookat((1, 0.3, -4), (0, 0, 0), (0, 1, 0), 60.0, 64, 48)
    tc = convert.camera_from_numpy(
        np.asarray(jc.viewmat), jc.fx, jc.fy, jc.cx, jc.cy, 64, 48, device="cpu"
    )
    np.testing.assert_allclose(
        torch_proj.view_directions(torch.from_numpy(leaves["means"]), tc).numpy(),
        np.asarray(jax_proj.view_directions(jnp.asarray(leaves["means"]), jc)),
        atol=1e-6,
    )


@pytest.mark.parametrize("fn", ["quat_to_rotmat", "compute_cov3d"])
def test_rotmat_and_cov3d_match_jax(fn):
    """Numpy-seeded quaternions of every norm (a zero one among them, whose
    norm is clipped at 1e-8) and splat scales (e^-5 to 1, so Σ is of order 1
    at most), batched (…, 4): atol 1e-6 in float32, a few ulps of an entry
    of order 1 (the two normalise by norms that differ in the last bit)."""
    rng = np.random.default_rng(11)
    norms = rng.uniform(0.01, 5.0, (5, 40, 1))
    quats = (rng.standard_normal((5, 40, 4)) * norms).astype(np.float32)
    quats[0, 0] = 0.0
    scales = np.exp(rng.uniform(-5.0, 0.0, (5, 40, 3))).astype(np.float32)
    args = (quats,) if fn == "quat_to_rotmat" else (quats, scales)
    got = getattr(torch_proj, fn)(*(torch.from_numpy(a) for a in args)).numpy()
    want = np.asarray(getattr(jax_proj, fn)(*(jnp.asarray(a) for a in args)))
    assert got.shape == want.shape == (5, 40, 3, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if fn == "quat_to_rotmat":
        np.testing.assert_array_equal(got[0, 0], np.eye(3, dtype=np.float32))
