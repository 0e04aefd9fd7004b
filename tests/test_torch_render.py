"""The slice as a whole: port `render` vs JAX `render` on the same scene."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splat_tpu.camera import Camera as JaxCamera
from gaussian_splat_tpu.config import RenderConfig as JaxConfig
from gaussian_splat_tpu.models.gaussians import GaussianModel as JaxModel
from gaussian_splat_tpu.ops.render import calibrate_render_config as jax_calibrate
from gaussian_splat_tpu.ops.render import render as jax_render
from gaussian_splat_tpu_torch import convert
from gaussian_splat_tpu_torch.config import RenderConfig as TorchConfig
from gaussian_splat_tpu_torch.ops.render import calibrate_render_config, render

ATOL, RTOL = 3e-5, 1e-4
W, H = 96, 64


def _setup(seed, n=120):
    leaves = convert.random_leaves(seed, n, sh_degree=1, extent=1.2, scale_range=(0.02, 0.1))
    jc = JaxCamera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, W, H)
    tc = convert.camera_from_numpy(
        np.asarray(jc.viewmat), jc.fx, jc.fy, jc.cx, jc.cy, W, H, device="cpu"
    )
    return JaxModel.create(**leaves), jc, convert.model_from_numpy(leaves, "cpu"), tc


BG = (0.3, 0.1, 0.6)


@functools.lru_cache(maxsize=None)
def _jax_reference_render(seed, backend):
    """One jitted JAX render per (seed, backend), shared by the port backends."""
    jm, jc, _, _ = _setup(seed)
    cfg = JaxConfig(backend=backend, background=BG)
    return jax.jit(lambda m, c: jax_render(m, c, cfg)[:3])(jm, jc)


def _assert_outputs_close(t_out, j_out):
    for i, name in enumerate(("image", "alpha", "depth")):
        np.testing.assert_allclose(
            t_out[i].detach().numpy(), np.asarray(j_out[i]),
            atol=ATOL, rtol=RTOL, err_msg=name,
        )


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("torch_backend", ["torch_tile", "reference"])
@pytest.mark.parametrize("jax_backend", ["jnp_tile", "pallas", "reference"])
def test_render_matches_jax(seed, torch_backend, jax_backend):
    _, _, tm, tc = _setup(seed)
    j_out = _jax_reference_render(seed, jax_backend)
    t_out = render(tm, tc, TorchConfig(backend=torch_backend, background=BG))
    _assert_outputs_close(t_out, j_out)
    assert (t_out.stats is None) == (torch_backend == "reference")


def test_antialiased_and_fixed_extent_match_jax():
    jm, jc, tm, tc = _setup(2)
    kw = dict(antialiased=True, opacity_aware_extent=False, sh_degree=0)
    j_cfg = JaxConfig(backend="jnp_tile", **kw)
    j_out = jax.jit(lambda m, c: jax_render(m, c, j_cfg)[:3])(jm, jc)
    t_out = render(tm, tc, TorchConfig(backend="torch_tile", **kw))
    _assert_outputs_close(t_out, j_out)


def test_calibration_matches_jax_and_is_bit_identical():
    jm, jc, tm, tc = _setup(0)
    j_cfg = jax_calibrate(jm, jc, JaxConfig())
    t_cfg = calibrate_render_config(tm, tc, TorchConfig())
    assert t_cfg.pairs_per_gaussian == j_cfg.pairs_per_gaussian
    assert t_cfg.big_tier_capacity == j_cfg.big_tier_capacity
    assert t_cfg.pairs_per_gaussian != TorchConfig().pairs_per_gaussian
    base = render(tm, tc, TorchConfig())
    cal = render(tm, tc, t_cfg)
    assert int(cal.stats.overflow) == int(cal.stats.tier_overflow) == 0
    assert torch.equal(base.image, cal.image)
    assert torch.equal(base.alpha, cal.alpha) and torch.equal(base.depth, cal.depth)
    # several cameras: the max over them
    t_cfg2 = calibrate_render_config(tm, [tc, tc.resized(64, 48)], TorchConfig())
    assert t_cfg2.pairs_per_gaussian >= t_cfg.pairs_per_gaussian


@pytest.mark.parametrize("case", ["grown_splat", "bands", "past_the_kernels",
                                  "cap_above_the_frame"])
def test_calibration_raises_the_cap_to_the_frame(case):
    """`calibrate_render_config` raises the K cap to the largest frame's tile
    count, at most the binning kernels' `MAX_K_BIG`, and never lowers it; the
    sharded calibration (`mesh_ndev`) alike. A splat grown past the given cap
    after calibration keeps its whole rect; before it grew, the calibrated
    config renders the given config's frame bit for bit."""
    from gaussian_splat_tpu_torch.ops.binning import MAX_K_BIG

    _, _, tm, tc = _setup(0)
    cam = tc.resized(256, 192)
    given = TorchConfig(max_tiles_per_gaussian={"cap_above_the_frame": 512}.get(case, 8))
    if case == "past_the_kernels":
        given = TorchConfig(tile_width=8, tile_height=8)
        cam = tc.resized(1024, 1024)
    cams = [cam, cam.resized(64, 48)]
    cal = calibrate_render_config(tm, cams, given,
                                  **({"mesh_ndev": 4} if case == "bands" else {}))
    frame = given.num_tiles(cam.width, cam.height)
    want = {"cap_above_the_frame": 512, "past_the_kernels": MAX_K_BIG}.get(case, frame)
    assert cal.max_tiles_per_gaussian == want
    if case == "past_the_kernels":
        assert frame > MAX_K_BIG
        return
    before = render(tm, cam, given)
    same = render(tm, cam, cal)
    assert int(before.stats.clamped_rects) == int(same.stats.clamped_rects) == 0
    assert torch.equal(before.image, same.image)
    with torch.no_grad():
        tm.log_scales[0] = np.log(0.8)
    shrunk, whole = render(tm, cam, given), render(tm, cam, cal)
    assert int(shrunk.stats.clamped_rects) == (case != "cap_above_the_frame")
    assert int(whole.stats.clamped_rects) == 0
    for k in ("overflow", "tier_overflow"):
        assert int(getattr(whole.stats, k)) == 0, k


def test_calibration_gives_the_tier_the_small_tiers_bytes():
    """With no splat past the small cap, the big tier still gets the rows
    that the small tier's bytes hold (N·k_small/K), room for splats that
    training grows; the frame renders as under the given config."""
    leaves = convert.random_leaves(5, 5000, sh_degree=1, extent=1.2, scale_range=(0.002, 0.004))
    tm = convert.model_from_numpy(leaves, "cpu")
    _, _, _, tc = _setup(0)
    given = TorchConfig()
    cal = calibrate_render_config(tm, tc, given)
    _, _, w, h, _ = _tile_rects_of(tm, tc, given)
    assert int(((w * h) > given.small_tiles_per_gaussian).sum()) == 0
    floor = 5000 * given.small_tiles_per_gaussian // cal.max_tiles_per_gaussian
    assert cal.big_tier_capacity == floor > 64
    before, after = render(tm, tc, given), render(tm, tc, cal)
    assert torch.equal(before.image, after.image)
    assert int(after.stats.tier_overflow) == int(after.stats.overflow) == 0


def _tile_rects_of(model, cam, config):
    from gaussian_splat_tpu_torch.ops.binning import tile_rects
    from gaussian_splat_tpu_torch.ops.render import _project_and_shade

    proj, _ = _project_and_shade(model, cam, config)
    return tile_rects(proj.means2d, proj.radii, proj.valid, cam.width, cam.height, config,
                      extents=proj.extents)


def test_screen_offset_shifts_like_jax():
    jm, jc, tm, tc = _setup(1)
    off = np.tile(np.array([[3.0, -2.0]], np.float32), (jm.num_gaussians, 1))
    j_cfg = JaxConfig(backend="jnp_tile")
    j_out = jax.jit(lambda m, c, o: jax_render(m, c, j_cfg, screen_offset=o)[:3])(
        jm, jc, jnp.asarray(off)
    )
    t_out = render(tm, tc, TorchConfig(), screen_offset=torch.from_numpy(off))
    _assert_outputs_close(t_out, j_out)
    plain = render(tm, tc, TorchConfig())
    assert float((plain.image - t_out.image).detach().abs().max()) > 1e-2


def test_torch_tile_is_differentiable_on_cpu():
    _, _, tm, tc = _setup(0, n=40)
    render(tm, tc, TorchConfig()).image.mean().backward()
    for name in tm.LEAVES:
        g = getattr(tm, name).grad
        assert g is not None and torch.isfinite(g).all() and float(g.abs().sum()) > 0, name


def test_camera_on_other_device_is_refused():
    _, _, tm, tc = _setup(0, n=10)
    meta_cam = tc.to("meta")
    with pytest.raises(ValueError, match="camera is on"):
        render(tm, meta_cam, TorchConfig())
