"""The slice's gradient: the five parameter gradients, and the gradient
w.r.t. `screen_offset`, through the port's `render` against `jax.grad` through
the JAX `render` on the same numpy scene (atol 5e-6 / rtol 3e-3, the
reference suite's gradient tolerance, tests/test_pallas.py:60-64).

The port's raster stage is taken both ways: autograd through the plain
compositor (backend "torch_tile"), and the explicit backward — the plain
versions of the two backward kernels behind the autograd.Function that CUDA
tensors take (here on CPU tensors, by routing backend "cuda" past its device
check)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splat_tpu.camera import Camera as JaxCamera
from gaussian_splat_tpu.config import RenderConfig as JaxConfig
from gaussian_splat_tpu.models.gaussians import GaussianModel as JaxModel
from gaussian_splat_tpu.ops.render import render as jax_render
from gaussian_splat_tpu_torch import convert
from gaussian_splat_tpu_torch.config import RenderConfig as TorchConfig
from gaussian_splat_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_tpu_torch.ops import cuda_raster, tile_raster
from gaussian_splat_tpu_torch.ops.render import render

ATOL, RTOL = 5e-6, 3e-3
W, H, N = 64, 48, 60
NAMES = (*GaussianModel.LEAVES, "screen_offset")


def _scene(seed):
    leaves = convert.random_leaves(seed, N, sh_degree=1, extent=1.2, scale_range=(0.02, 0.1))
    target = np.random.default_rng(seed + 9).uniform(0, 1, (H, W, 3)).astype(np.float32)
    return leaves, target


def _loss(out, target, lib):
    return (
        lib.mean((out.image - target) ** 2) + 0.1 * lib.mean(out.depth)
        + 0.1 * lib.mean(out.alpha)
    )


@functools.lru_cache(maxsize=None)
def _jax_grads(seed, backend):
    leaves, target = _scene(seed)
    cam = JaxCamera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, W, H)
    cfg = JaxConfig(backend=backend, exact_vjp=True, background=(0.2, 0.1, 0.4))

    def loss(model, off):
        return _loss(jax_render(model, cam, cfg, screen_offset=off), jnp.asarray(target), jnp)

    g_model, g_off = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        JaxModel.create(**leaves), jnp.zeros((N, 2))
    )
    grads = {k: np.asarray(getattr(g_model, k)) for k in GaussianModel.LEAVES}
    grads["screen_offset"] = np.asarray(g_off)
    return grads


def _torch_grads(seed, backend):
    leaves, target = _scene(seed)
    jc = JaxCamera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, W, H)
    cam = convert.camera_from_numpy(
        np.asarray(jc.viewmat), jc.fx, jc.fy, jc.cx, jc.cy, W, H, device="cpu"
    )
    model = convert.model_from_numpy(leaves, "cpu")
    off = torch.zeros((N, 2), requires_grad=True)
    cfg = TorchConfig(backend=backend, background=(0.2, 0.1, 0.4))
    out = render(model, cam, cfg, screen_offset=off)
    _loss(out, torch.from_numpy(target), torch).backward()
    grads = {k: getattr(model, k).grad.numpy() for k in GaussianModel.LEAVES}
    grads["screen_offset"] = off.grad.numpy()
    return grads


@pytest.fixture
def explicit_backward_on_cpu(monkeypatch):
    """Backend "cuda" → the autograd.Function with the plain versions."""
    def render_tiled(proj, colors, opacities, width, height, config):
        return tile_raster.render_tiled(
            proj, colors, opacities, width, height, config,
            raster_fn=cuda_raster.rasterize,
        )

    monkeypatch.setattr(cuda_raster, "render_tiled_cuda", render_tiled)


def _assert_close(got, want, what):
    for k in NAMES:
        assert np.isfinite(got[k]).all(), (what, k)
        np.testing.assert_allclose(
            got[k], want[k], atol=ATOL, rtol=RTOL, err_msg=f"{what}: d{k}"
        )
        assert float(np.abs(want[k]).max()) > 10 * ATOL, (what, k)


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("raster", ["autograd", "explicit"])
def test_render_gradients_match_jax(seed, raster, request):
    if raster == "explicit":
        request.getfixturevalue("explicit_backward_on_cpu")
    got = _torch_grads(seed, "cuda" if raster == "explicit" else "torch_tile")
    _assert_close(got, _jax_grads(seed, "jnp_tile"), f"{raster} vs jnp_tile")


def test_render_gradients_match_pallas_exact_vjp(explicit_backward_on_cpu):
    _assert_close(_torch_grads(3, "cuda"), _jax_grads(3, "pallas"), "explicit vs pallas")


def test_render_gradients_match_the_oracle(explicit_backward_on_cpu):
    _assert_close(_torch_grads(3, "cuda"), _torch_grads(3, "reference"), "explicit vs oracle")
