"""Level-of-detail subsets, the AABB clip and the two per-splat measurements
(`measure_pair_costs`, `measure_splat_contributions`) against the JAX
package's."""

import numpy as np
import pytest
import torch

from gaussian_splat_tpu.camera import Camera as JaxCamera
from gaussian_splat_tpu.config import RenderConfig as JaxConfig
from gaussian_splat_tpu.models.gaussians import GaussianModel as JaxModel
from gaussian_splat_tpu.ops import binning as jax_binning
from gaussian_splat_tpu.ops import render as jax_render
from gaussian_splat_tpu_torch import convert
from gaussian_splat_tpu_torch.config import RenderConfig
from gaussian_splat_tpu_torch.ops import binning as torch_binning
from gaussian_splat_tpu_torch.ops import render as torch_render

W, H = 96, 64
GRAD_RTOL, GRAD_ATOL_REL = 3e-3, 5e-6


def _leaves(kind, n=300):
    if kind == "random":
        return convert.random_leaves(4, n, sh_degree=1, extent=1.2, scale_range=(0.02, 0.3))
    # many exact ties in impact: three scales, three logits, isotropic
    leaves = convert.random_leaves(5, n, sh_degree=0, extent=1.2)
    rng = np.random.default_rng(6)
    leaves["log_scales"] = np.repeat(
        np.log(rng.choice([0.03, 0.08, 0.15], n))[:, None], 3, axis=1
    ).astype(np.float32)
    leaves["opacity_logits"] = rng.choice([-1.0, 0.5, 2.0], n).astype(np.float32)
    return leaves


@pytest.fixture(scope="module", params=["random", "ties"])
def scene(request):
    leaves = _leaves(request.param)
    jm = JaxModel.create(**leaves)
    tm = convert.model_from_numpy(leaves, "cpu")
    jc = JaxCamera.from_lookat((0.0, 2.0, 5.0), (0, 0, 0), (0, 1, 0), 45.0, W, H)
    tc = convert.camera_from_numpy(
        np.asarray(jc.viewmat), jc.fx, jc.fy, jc.cx, jc.cy, W, H, device="cpu"
    )
    return leaves, jm, tm, jc, tc


def _assert_same_subset(got, want):
    """Integer-exact keep sets: the same rows, in the same order."""
    assert got.num_gaussians == want.num_gaussians
    for name in got.LEAVES:
        np.testing.assert_array_equal(
            getattr(got, name).detach().numpy(), np.asarray(getattr(want, name)), err_msg=name
        )


@pytest.mark.parametrize("fraction", [0.0, 0.1, 0.25, 0.5, 1.0])
def test_lod_keeps_the_jax_set(scene, fraction):
    _, jm, tm, _, _ = scene
    _assert_same_subset(tm.lod(fraction), jm.lod(fraction))


@pytest.mark.parametrize("order", ["value", "density"])
@pytest.mark.parametrize("with_costs,with_values", [(False, False), (True, False),
                                                    (False, True), (True, True)])
def test_lod_pair_budget_keeps_the_jax_set(scene, order, with_costs, with_values):
    _, jm, tm, jc, _ = scene
    costs = (np.asarray(jax_render.measure_pair_costs(jm, jc, JaxConfig(backend="jnp_tile")))
             if with_costs else None)
    values = (np.random.default_rng(9).uniform(0, 1, tm.num_gaussians).astype(np.float32)
              if with_values else None)
    for frac in (0.05, 0.3):
        want = jm.lod_pair_budget(frac, costs, values, order=order)
        _assert_same_subset(tm.lod_pair_budget(frac, costs, values, order=order), want)
        if costs is not None:  # tensors are taken as well as arrays
            got = tm.lod_pair_budget(frac, torch.tensor(costs), values, order=order)
            _assert_same_subset(got, want)


@pytest.mark.parametrize("radius", [0.5, 1.0, 5.0])
def test_aabb_filter_keeps_the_jax_set(scene, radius):
    _, jm, tm, _, _ = scene
    _assert_same_subset(tm.aabb_filter(radius), jm.aabb_filter(radius))


def test_subsets_are_new_models_on_the_same_device(scene):
    leaves, _, tm, _, _ = scene
    sub = tm.lod(0.5)
    assert sub is not tm and sub.device == tm.device
    with torch.no_grad():
        sub.means.add_(1.0)  # a subset shares no storage with its model
    np.testing.assert_array_equal(tm.means.detach().numpy(), leaves["means"])


def test_measure_pair_costs_is_exact(scene):
    _, jm, tm, jc, tc = scene
    want = np.asarray(jax_render.measure_pair_costs(jm, jc, JaxConfig(backend="jnp_tile")))
    got = torch_render.measure_pair_costs(tm, tc, RenderConfig(), device="cpu")
    assert isinstance(got, np.ndarray) and got.shape == (tm.num_gaussians,)
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0


def test_measure_pair_costs_rects_on_jax_projection(scene):
    """Stage by stage: the port's rect pass fed JAX's projection outputs."""
    _, jm, _, jc, _ = scene
    jcfg = JaxConfig(backend="jnp_tile")
    proj, _ = jax_render._project_and_shade(jm, jc, jcfg)
    _, _, jw, jh, _ = jax_binning.tile_rects(
        proj.means2d, proj.radii, proj.valid, W, H, jcfg, extents=proj.extents
    )
    t = {k: torch.tensor(np.asarray(getattr(proj, k)))
         for k in ("means2d", "radii", "valid", "extents")}
    _, _, tw, th, _ = torch_binning.tile_rects(
        t["means2d"], t["radii"], t["valid"], W, H, RenderConfig(), extents=t["extents"]
    )
    np.testing.assert_array_equal((tw * th).numpy(), np.asarray(jw * jh))


def test_measure_splat_contributions_matches_jax(scene):
    leaves, jm, tm, jc, tc = scene
    want = np.asarray(jax_render.measure_splat_contributions(
        jm, jc, JaxConfig(backend="jnp_tile")))
    got = torch_render.measure_splat_contributions(tm, tc, RenderConfig(), device="cpu")
    assert got.shape == want.shape and np.isfinite(got).all() and want.max() > 0
    tol = GRAD_RTOL * np.abs(want) + GRAD_ATOL_REL * np.abs(want).max()
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()
    # nothing left on the model: no .grad, and its leaves are untouched
    for name in tm.LEAVES:
        assert getattr(tm, name).grad is None
        np.testing.assert_array_equal(getattr(tm, name).detach().numpy(), leaves[name])


def test_measurements_go_through_the_explicit_backward(scene, monkeypatch):
    """On CPU tensors the contributions take the raster kernels' plain
    versions through `cuda_raster.rasterize`, one call each."""
    from gaussian_splat_tpu_torch.ops import cuda_raster, tile_raster

    _, _, tm, _, tc = scene
    calls = {"fwd": 0, "bwd": 0, "seg": 0}
    for name, key in (("raster_forward_torch", "fwd"), ("raster_backward_torch", "bwd"),
                      ("segment_sum_torch", "seg")):
        real = getattr(tile_raster, name)

        def counted(*a, real=real, key=key, **k):
            calls[key] += 1
            return real(*a, **k)

        monkeypatch.setattr(tile_raster, name, counted)
    torch_render.measure_splat_contributions(tm, tc, RenderConfig(backend="reference"),
                                             device="cpu")
    assert calls == {"fwd": 1, "bwd": 1, "seg": 1}
    assert cuda_raster.launch_counts == dict.fromkeys(cuda_raster.KERNELS, 0)


def test_measurements_need_their_device(scene):
    _, _, tm, _, tc = scene
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            torch_render.measure_pair_costs(tm, tc)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            torch_render.measure_splat_contributions(tm, tc)
    with pytest.raises(ValueError, match="lies on cpu"):
        torch_render.measure_pair_costs(tm, tc, device="meta")
