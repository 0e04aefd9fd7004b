"""The binning kernels (csrc/binning.cu: bin_rects, bin_count, bin_offsets,
bin_scatter) on the card, against the plain version
(ops/binning.py::bin_gaussians_torch) run on the same card: every field bit
for bit, pair_src on every pair (0 on padding rows in both). Every test is
marked `card` and skips without an NVIDIA card. This file imports no JAX; on
a machine with a card and without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_binning_cuda.py

(tests/conftest.py sets JAX up for the CPU tests; --noconftest leaves it out.)
"""

import dataclasses

import numpy as np
import pytest
import torch

from gaussian_splat_tpu_torch import Camera, GaussianModel, RenderConfig, render
from gaussian_splat_tpu_torch.ops import binning, cuda_raster
from gaussian_splat_tpu_torch.ops.projection import ProjectedGaussians, project_gaussians

pytestmark = pytest.mark.card

ALPHA_SKIP = 1.0 / 255.0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _project(model, cam):
    op = torch.sigmoid(model.opacity_logits.detach())
    with torch.no_grad():
        proj = project_gaussians(model.means.detach(), model.quats.detach(),
                                 torch.exp(model.log_scales.detach()), cam, opacities=op,
                                 alpha_skip=ALPHA_SKIP)
    return proj, op


def _scene(dev, n=20_000, width=320, height=240, seed=0, scale_range=(0.005, 0.15),
           eye=(0.0, 0.3, -4.0), target=(0.0, 0.0, 0.0)):
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = GaussianModel.random(gen, n, sh_degree=0, extent=1.5, scale_range=scale_range,
                                 device=dev)
    cam = Camera.from_lookat(eye, target, (0, 1, 0), 60.0, width, height, device=dev)
    return _project(model, cam) + (cam,)


def _tied_scene(dev, side=40, width=320, height=240):
    """A side × side grid of equal splats facing the camera: rects of equal
    areas, so a small big tier is cut inside a tie."""
    g = np.linspace(-1.2, 1.2, side)
    means = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)
    n = means.shape[0]
    model = GaussianModel.create(
        means=np.concatenate([means, np.zeros((n, 1))], 1),
        quats=np.tile([1.0, 0.0, 0.0, 0.0], (n, 1)),
        log_scales=np.full((n, 3), np.log(0.06)),
        opacity_logits=np.full((n,), 2.0), sh=np.zeros((n, 1, 3)), device=dev)
    cam = Camera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, width, height, device=dev)
    return _project(model, cam) + (cam,)


def _both(proj, width, height, cfg, opac, **band):
    got = binning.bin_gaussians(proj, width, height, cfg, opacities=opac, **band)
    want = binning.bin_gaussians_torch(proj, width, height, cfg, opacities=opac, **band)
    torch.cuda.synchronize()
    return got, want


def _assert_equal(got, want):
    for name in binning.BinningResult._fields:
        g, w = getattr(got, name), getattr(want, name)
        if name == "kept":
            for field, gk, wk in zip(binning.KeptCells._fields, g, w):
                assert gk.dtype == wk.dtype and torch.equal(gk, wk), f"kept.{field}"
        else:
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert torch.equal(g, w), name


CASES = {
    # name: (config fields, scene keywords, expected non-zero sentinel)
    "default": ({}, {}, None),
    "tiles20x10": ({"tile_width": 20, "tile_height": 10}, {"width": 330, "height": 250}, None),
    "k256": ({"max_tiles_per_gaussian": 256}, {"scale_range": (0.01, 0.6)}, None),
    "clamped": ({"max_tiles_per_gaussian": 8}, {"scale_range": (0.05, 0.6)}, "clamped_rects"),
    "overflow": ({"pairs_per_gaussian": 0.2}, {}, "overflow"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernels_equal_the_plain_version(dev, case):
    fields, scene, sentinel = CASES[case]
    proj, op, cam = _scene(dev, **scene)
    cfg = RenderConfig(**fields)
    got, want = _both(proj, cam.width, cam.height, cfg, op)
    _assert_equal(got, want)
    assert int(got.num_pairs) > 0
    if sentinel is not None:
        assert int(getattr(got, sentinel)) > 0


# frames at whose tile count calibrate_render_config sets the K cap (at most
# MAX_K_BIG): rubble's and truck's frames, and one of 16,200 tiles
BIG_K_FRAMES = {"rubble_frame": (1152, 864), "truck_frame": (979, 546),
                "max_k_big": (3840, 2160)}


@pytest.mark.parametrize("case", list(BIG_K_FRAMES))
def test_caps_that_calibration_gives(dev, case):
    """K at the frame's tile count (1944 at 1152x864, 1085 at 979x546) and,
    past 8192 tiles, at MAX_K_BIG, under splats whose rects span up to the
    whole frame: big rows of up to 256 words, a histogram of K + 1 areas,
    the tier cut among them; past MAX_K_BIG the largest rects shrink."""
    width, height = BIG_K_FRAMES[case]
    proj, op, cam = _scene(dev, width=width, height=height, scale_range=(0.002, 0.8))
    frame = RenderConfig().num_tiles(width, height)
    cfg = RenderConfig(max_tiles_per_gaussian=min(frame, binning.MAX_K_BIG),
                       pairs_per_gaussian=64.0)
    got, want = _both(proj, width, height, cfg, op)
    _assert_equal(got, want)
    uncapped = dataclasses.replace(cfg, max_tiles_per_gaussian=frame)
    _, _, w, h, _ = binning.tile_rects(proj.means2d, proj.radii, proj.valid, width, height,
                                       uncapped, extents=proj.extents)
    assert int((w * h).max()) > 256 and int(got.tier_overflow) > 0
    # clamped_rects counts the tier's losers, shrunk to the small cap, and
    # the rects past K: past MAX_K_BIG only
    k_shrunk = int(got.clamped_rects) - int(got.tier_overflow)
    assert (k_shrunk > 0) == (frame > binning.MAX_K_BIG) and k_shrunk >= 0


def test_without_opacities_every_rect_cell_is_kept(dev):
    proj, _, cam = _scene(dev, seed=1)
    got, want = _both(proj, cam.width, cam.height, RenderConfig(), None)
    _assert_equal(got, want)
    assert int(got.num_pairs) == int(got.kept.small.sum() + got.kept.big.sum())


def test_band_with_max_active_drops_splats(dev):
    """The sharded path's form: band 1 of 3 on the global grid, the inputs
    as column views of one record matrix (a row stride), max_active below
    the band's splats."""
    proj, op, cam = _scene(dev, n=30_000, height=480, seed=2)
    cfg = RenderConfig()
    total_y = cfg.tiles_y(cam.height)
    rows = -(-total_y // 3)
    feats = torch.cat([proj.means2d, proj.conics, op[:, None], proj.extents], 1)
    band = ProjectedGaussians(
        means2d=feats[:, 0:2], conics=feats[:, 2:5], depths=proj.depths, radii=proj.radii,
        valid=proj.valid, cov2d=proj.cov2d, extents=feats[:, 6:8].contiguous())
    got, want = _both(band, cam.width, rows * cfg.tile_height, cfg, feats[:, 5],
                      max_active=4_000, tile_row0=rows, total_tiles_y=total_y)
    _assert_equal(got, want)
    assert int(got.dropped_gaussians) > 0 and got.num_active == 4_000


def test_tier_overflow_cut_inside_a_tie(dev):
    proj, op, cam = _tied_scene(dev)
    area = (binning.tile_rects(proj.means2d, proj.radii, proj.valid, cam.width, cam.height,
                               RenderConfig(), extents=proj.extents)[2:4])
    eligible = int(((area[0] * area[1]) > 2).sum())
    cfg = RenderConfig(small_tiles_per_gaussian=2, big_tier_capacity=eligible // 3 + 1)
    got, want = _both(proj, cam.width, cam.height, cfg, op)
    _assert_equal(got, want)
    assert int(got.tier_overflow) > 0


def test_every_splat_culled(dev):
    proj, op, cam = _scene(dev, eye=(0.0, 0.0, -4.0), target=(0.0, 0.0, -9.0))
    assert not bool(proj.valid.any())
    got, want = _both(proj, cam.width, cam.height, RenderConfig(), op)
    _assert_equal(got, want)
    assert int(got.num_pairs) == 0 and bool((got.pair_tile == got.tile_counts.numel()).all())


@pytest.mark.parametrize("n", [50_000, 2_200_000])
def test_tiles_past_shared_memory(dev, n):
    """8×8 tiles at 1024×1024: 16,384 tile counters, past one block's shared
    memory, so the counts and the counters live in device memory; at 2.2M
    splats the histogram rows are grouped as well."""
    proj, op, cam = _scene(dev, n=n, width=1024, height=1024, scale_range=(0.002, 0.05))
    cfg = RenderConfig(tile_width=8, tile_height=8, max_tiles_per_gaussian=64)
    assert cfg.num_tiles(cam.width, cam.height) > 11_264
    got, want = _both(proj, cam.width, cam.height, cfg, op)
    _assert_equal(got, want)


def test_two_runs_are_bitwise_equal_and_launch_once(dev):
    proj, op, cam = _scene(dev, seed=3)
    cfg = dataclasses.replace(RenderConfig(), max_tiles_per_gaussian=64)
    cuda_raster.reset_launch_counts()
    first = binning.bin_gaussians(proj, cam.width, cam.height, cfg, opacities=op)
    again = binning.bin_gaussians(proj, cam.width, cam.height, cfg, opacities=op)
    torch.cuda.synchronize()
    _assert_equal(first, again)
    assert all(cuda_raster.launch_counts[k] == 2 for k in binning.KERNELS)
    gen = torch.Generator(device=dev).manual_seed(4)
    model = GaussianModel.random(gen, 500, sh_degree=1, extent=1.0, scale_range=(0.02, 0.08),
                                 device=dev)
    cuda_raster.reset_launch_counts()
    render(model, Camera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, 96, 64,
                                     device=dev), RenderConfig()).image.sum().backward()
    assert cuda_raster.launch_counts == dict.fromkeys(cuda_raster.KERNELS, 1)


def test_refuses_what_the_kernels_do_not_take(dev):
    proj, op, cam = _scene(dev, n=1_000)
    cuda_raster.reset_launch_counts()
    with pytest.raises(TypeError):
        binning.bin_gaussians(proj._replace(means2d=proj.means2d.double()), cam.width,
                              cam.height, RenderConfig(), opacities=op)
    with pytest.raises(ValueError):
        binning.bin_gaussians(proj, cam.width, cam.height,
                              RenderConfig(small_tiles_per_gaussian=33), opacities=op)
    with pytest.raises(ValueError):
        binning.bin_gaussians(proj, cam.width, cam.height, RenderConfig(), opacities=op,
                              max_active=0)
    assert all(cuda_raster.launch_counts[k] == 0 for k in binning.KERNELS)
