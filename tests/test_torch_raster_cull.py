"""The per-warp cull of the CUDA raster kernels, through its plain mirror.

While the kernels stage a batch of pairs they compute a conservative extent
per splat (`splat_extent` in csrc/raster_common.cuh) and let a warp skip a pair
whose extent misses the warp's pixel rectangle. The cull may only skip steps
that the keep test (`sigma >= 0 & sigma <= bound`, in float32, by
`sigma_quadform`) would have failed. `tile_raster.splat_extent_torch`,
`extent_misses_rect`, `tile_thread_pixels` and `tile_warp_rects` mirror the
kernels' code operation for operation; here they are held against the keep
mask of the port's and of the JAX package's falloff code, on seeded draws, on
hypothesis' draws, on degenerate rows and on the golden scene's table.
"""

import os

import hypothesis
import hypothesis.strategies as st
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splat_tpu.ops import falloff as jax_falloff
from gaussian_splat_tpu_torch import Camera, RenderConfig
from gaussian_splat_tpu_torch.io.ply import load_gaussians
from gaussian_splat_tpu_torch.ops import cuda_raster, falloff, tile_raster
from gaussian_splat_tpu_torch.ops.binning import bin_gaussians
from gaussian_splat_tpu_torch.ops.render import _effective_opacities, _project_and_shade
from gaussian_splat_tpu_torch.ops.tile_raster import (
    COL_A, COL_B, COL_BOUND, COL_C, COL_MX, COL_MY,
)

TILES = [(32, 16), (16, 16), (20, 10)]  # 8x4 warps, 8x4 warps, row-major warps
SIGMA_CUTOFF, ALPHA_SKIP = 4.5, 1.0 / 255.0
SCENE = os.path.join(os.path.dirname(__file__), "golden", "scene.ply")


def _rows(mx, my, A, B, C, bound):
    """(n, 12) float32 table rows with only the columns the cull reads."""
    cols = np.broadcast_arrays(*(np.asarray(x, np.float64) for x in (mx, my, A, B, C, bound)))
    rows = np.zeros((cols[0].size, tile_raster.TABLE_COLS), np.float32)
    for col, x in zip((COL_MX, COL_MY, COL_A, COL_B, COL_C, COL_BOUND), cols):
        rows[:, col] = x.reshape(-1)
    return torch.from_numpy(rows)


def _conic(s1, s2, angle):
    """Conic (A, B, C) of the covariance R diag(s1², s2²) Rᵀ, in float64."""
    c, s = np.cos(angle), np.sin(angle)
    a = c * c / s1**2 + s * s / s2**2
    b = c * s * (1.0 / s1**2 - 1.0 / s2**2)
    cc = s * s / s1**2 + c * c / s2**2
    return a, b, cc


def _bound(opacity):
    return falloff.sigma_bound(
        torch.as_tensor(opacity, dtype=torch.float32), torch.tensor(True),
        SIGMA_CUTOFF, ALPHA_SKIP,
    ).numpy()


def _random_rows(rng, n, tile, origin):
    """Splats over six decades of scale and strong anisotropy, with centres
    placed so that the boundary of the kept region often crosses the tile."""
    s1 = 10.0 ** rng.uniform(-0.5, 5.5, n)
    s2 = s1 * 10.0 ** rng.uniform(-3.0, 0.0, n)
    A, B, C = _conic(s1, s2, rng.uniform(0.0, np.pi, n))
    bound = _bound(rng.uniform(ALPHA_SKIP, 1.0, n))
    reach = np.sqrt(2.0 * np.maximum(bound, 0.0)) * s1  # the longest half-axis
    aim = np.asarray(origin) + rng.uniform(0.0, 1.0, (n, 2)) * np.asarray(tile)
    away = rng.uniform(0.0, 2.0 * np.pi, n)
    dist = reach * rng.uniform(0.0, 1.5, n)
    mx, my = aim[:, 0] + dist * np.cos(away), aim[:, 1] + dist * np.sin(away)
    return _rows(mx, my, A, B, C, bound)


def _keep_mask(rows, px, py):
    """(n, npix) keep mask of the port's falloff code, float32, as the kernels
    evaluate it: dx, dy rounded, then `sigma_quadform`."""
    dx = px[None, :] - rows[:, COL_MX : COL_MX + 1]
    dy = py[None, :] - rows[:, COL_MY : COL_MY + 1]
    sigma = falloff.sigma_quadform(
        dx, dy, 0.5 * rows[:, COL_A : COL_A + 1], rows[:, COL_B : COL_B + 1],
        0.5 * rows[:, COL_C : COL_C + 1],
    )
    bound = rows[:, COL_BOUND : COL_BOUND + 1]
    return (sigma >= 0.0) & (sigma <= bound), dx, dy


def _check_tile(rows, tile, origin):
    """Asserts the cull's two properties on one tile at `origin`; returns
    (kept steps, (warp, pair)s culled, (warp, pair)s in all)."""
    tw, th = tile
    pix = tile_raster.tile_thread_pixels(tw, th)
    px = torch.from_numpy((pix[:, 0] + origin[0]).astype(np.float32)) + 0.5
    py = torch.from_numpy((pix[:, 1] + origin[1]).astype(np.float32)) + 0.5
    keep, dx, dy = _keep_mask(rows, px, py)
    ext = tile_raster.splat_extent_torch(rows)
    hx, hy = ext[:, 2:3], ext[:, 3:4]
    # every kept pixel centre lies inside the extent
    outside = keep & ~((dx.abs() <= hx) & (dy.abs() <= hy))
    assert not bool(outside.any()), f"{int(outside.sum())} kept pixels outside their extent"
    # a warp whose rectangle misses the extent holds no kept pixel
    rects = tile_raster.tile_warp_rects(tw, th)
    culled = 0
    for w, (x0, x1, y0, y1) in enumerate(rects):
        corner = [np.float32(v) + np.float32(0.5) for v in
                  (x0 + origin[0], x1 + origin[0], y0 + origin[1], y1 + origin[1])]
        miss = tile_raster.extent_misses_rect(ext, *corner)
        in_warp = keep[:, w * 32 : (w + 1) * 32]
        lost = miss[:, None] & in_warp
        assert not bool(lost.any()), f"warp {w}: the cull would drop {int(lost.sum())} kept steps"
        culled += int(miss.sum())
    return int(keep.sum()), culled, rows.shape[0] * len(rects)


@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_layout_covers_the_tile_once(tile):
    """Thread → pixel is a bijection onto the tile, and every thread's pixel
    lies in its warp's rectangle; 8×4 blocks where the shape allows them."""
    tw, th = tile
    pix = tile_raster.tile_thread_pixels(tw, th)
    rects = tile_raster.tile_warp_rects(tw, th)
    assert sorted(map(tuple, pix)) == sorted((x, y) for y in range(th) for x in range(tw))
    assert len(rects) == -(-tw * th // 32)
    for p, (x, y) in enumerate(pix):
        x0, x1, y0, y1 = rects[p // 32]
        assert x0 <= x <= x1 and y0 <= y <= y1
    if tw % 8 == 0 and th % 4 == 0:
        assert all((x1 - x0, y1 - y0) == (7, 3) for x0, x1, y0, y1 in rects)
    else:  # row-major: thread p owns pixel p
        assert [tuple(v) for v in pix] == [(p % tw, p // tw) for p in range(tw * th)]


@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cull_never_drops_a_kept_step_seeded(tile, seed):
    rng = np.random.default_rng(seed)
    kept = culled = total = 0
    for origin in [(0, 0), (tile[0] * 37, tile[1] * 41), (1888, 1064)]:
        k, c, t = _check_tile(_random_rows(rng, 1500, tile, origin), tile, origin)
        kept, culled, total = kept + k, culled + c, total + t
    # the draws exercise both sides: steps are kept, and warps are culled
    assert kept > 1000 and 0.05 * total < culled < 0.95 * total


@hypothesis.settings(max_examples=150, deadline=None, derandomize=True)
@hypothesis.given(
    log_s1=st.floats(-0.5, 5.5), log_ratio=st.floats(-3.0, 0.0),
    angle=st.floats(0.0, np.pi), opacity=st.floats(ALPHA_SKIP, 1.0, exclude_min=True),
    off_x=st.floats(-2.0, 2.0), off_y=st.floats(-2.0, 2.0),
    tile_index=st.integers(0, len(TILES) - 1),
    tile_x=st.integers(0, 100), tile_y=st.integers(0, 100),
)
def test_cull_never_drops_a_kept_step_hypothesis(
    log_s1, log_ratio, angle, opacity, off_x, off_y, tile_index, tile_x, tile_y
):
    tile = TILES[tile_index]
    origin = (tile_x * tile[0], tile_y * tile[1])
    s1 = 10.0**log_s1
    A, B, C = _conic(s1, s1 * 10.0**log_ratio, angle)
    bound = _bound(opacity)
    reach = np.sqrt(2.0 * max(float(bound), 0.0)) * s1
    mx = origin[0] + 0.5 * tile[0] + off_x * (reach + tile[0])
    my = origin[1] + 0.5 * tile[1] + off_y * (reach + tile[1])
    _check_tile(_rows(mx, my, A, B, C, bound), tile, origin)


@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_degenerate_rows(tile):
    """bound = −1 → empty extent, every warp culled, nothing kept; a conic that
    is not safely positive definite or any non-finite value → infinite extent,
    never culled; and the cull's properties hold on all of them."""
    origin = (64, 32)
    cx, cy = origin[0] + 0.5 * tile[0], origin[1] + 0.5 * tile[1]
    nan, inf = float("nan"), float("inf")
    invalid = _rows(cx, cy, 0.05, 0.01, 0.04, -1.0)
    unsafe = torch.cat([
        _rows(cx, cy, 0.04, 0.04, 0.04, 4.5),     # det = 0
        _rows(cx, cy, 0.04, 0.05, 0.04, 4.5),     # det < 0
        _rows(cx, cy, 1.0, 1.0 - 1e-7, 1.0, 4.5),  # det > 0 but inside the margin
        _rows(cx, cy, -0.04, 0.0, 0.04, 4.5),     # A < 0
        _rows(cx, cy, 0.04, 0.0, 0.0, 4.5),       # C = 0
        _rows(cx, cy, 1e-20, 0.0, 1e-20, 4.5),    # A·C near the denormals
        _rows(nan, cy, 0.04, 0.0, 0.04, 4.5),
        _rows(cx, inf, 0.04, 0.0, 0.04, 4.5),
        _rows(cx, cy, nan, 0.0, 0.04, 4.5),
        _rows(cx, cy, 0.04, inf, 0.04, 4.5),
        _rows(cx, cy, 0.04, 0.0, -inf, 4.5),
        _rows(cx, cy, 0.04, 0.0, 0.04, nan),
        _rows(cx, cy, 0.04, 0.0, 0.04, inf),
        _rows(cx, cy, 3e38, 0.0, 3e38, 4.5),      # A·C overflows
    ])
    ext = tile_raster.splat_extent_torch(invalid)
    assert bool((ext[:, 2:] == -inf).all())
    kept, culled, total = _check_tile(invalid, tile, origin)
    assert kept == 0 and culled == total

    ext = tile_raster.splat_extent_torch(unsafe)
    assert bool((ext[:, 2:] == inf).all()), ext[:, 2:]
    _, culled, _ = _check_tile(unsafe, tile, origin)
    assert culled == 0
    # an invalid row stays empty whatever else it holds
    both = unsafe.clone()
    both[:, COL_BOUND] = -1.0
    assert bool((tile_raster.splat_extent_torch(both)[:, 2:] == -inf).all())


def test_extent_is_tight_for_ordinary_splats():
    """The margins cost little: for well-conditioned splats the half-extents
    exceed the exact ones by under 2e-5 of their size plus 1/64 pixel."""
    rng = np.random.default_rng(5)
    n = 1000
    s1 = 10.0 ** rng.uniform(-0.3, 2.0, n)
    s2 = s1 * 10.0 ** rng.uniform(-1.0, 0.0, n)
    A, B, C = _conic(s1, s2, rng.uniform(0.0, np.pi, n))
    bound = _bound(rng.uniform(0.05, 1.0, n)).astype(np.float64)
    ext = tile_raster.splat_extent_torch(_rows(0.0, 0.0, A, B, C, bound)).double().numpy()
    det = A * C - B * B
    for got, want in ((ext[:, 2], np.sqrt(2 * bound * C / det)),
                      (ext[:, 3], np.sqrt(2 * bound * A / det))):
        assert np.all(got >= want)
        assert np.all(got <= want * (1 + 1e-4) + 2.0**-6 + 1e-6)


def test_keep_mask_is_the_jax_package_s():
    """The keep mask the extents are held against is the reference's: the same
    rows through gaussian_splat_tpu.ops.falloff give the same mask, bit for
    bit, and its kept pixels lie inside the port's extents."""
    tile, origin = (32, 16), (96, 48)
    rows = _random_rows(np.random.default_rng(11), 800, tile, origin)
    pix = tile_raster.tile_thread_pixels(*tile)
    px = (pix[:, 0] + origin[0]).astype(np.float32) + np.float32(0.5)
    py = (pix[:, 1] + origin[1]).astype(np.float32) + np.float32(0.5)
    keep, dx, dy = _keep_mask(rows, torch.from_numpy(px), torch.from_numpy(py))
    r = rows.numpy()
    jdx = jnp.asarray(px)[None, :] - jnp.asarray(r[:, COL_MX : COL_MX + 1])
    jdy = jnp.asarray(py)[None, :] - jnp.asarray(r[:, COL_MY : COL_MY + 1])
    sigma = jax_falloff.sigma_quadform(
        jdx, jdy, 0.5 * jnp.asarray(r[:, COL_A : COL_A + 1]),
        jnp.asarray(r[:, COL_B : COL_B + 1]), 0.5 * jnp.asarray(r[:, COL_C : COL_C + 1]),
    )
    jax_keep = np.asarray((sigma >= 0.0) & (sigma <= r[:, COL_BOUND : COL_BOUND + 1]))
    np.testing.assert_array_equal(jax_keep, keep.numpy())
    ext = tile_raster.splat_extent_torch(rows).numpy()
    inside = (np.abs(np.asarray(jdx)) <= ext[:, 2:3]) & (np.abs(np.asarray(jdy)) <= ext[:, 3:4])
    assert jax_keep.sum() > 1000 and not (jax_keep & ~inside).any()


@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@torch.no_grad()
def test_golden_scene_table(tile):
    """Real data: the extents of the golden scene's table against the keep
    mask of `pair_pixel_sigma`, over every tile's pair segment."""
    model = load_gaussians(SCENE, device="cpu")
    cam = Camera.from_lookat((0.0, 1.2, -2.6), (0, 0, 0), (0, 1, 0), 50.0, 160, 120, device="cpu")
    cfg = RenderConfig(tile_width=tile[0], tile_height=tile[1])
    proj, colors = _project_and_shade(model, cam, cfg)
    opac = _effective_opacities(model, proj, cfg)
    binning = bin_gaussians(proj, cam.width, cam.height, cfg, opacities=opac)
    table = tile_raster.build_splat_table(proj, colors, opac, binning.order, cfg)
    tx_n = cfg.tiles_x(cam.width)
    rows, local_tile, _, px, py, sigma = tile_raster.pair_pixel_sigma(
        table, binning.pair_gauss, binning.tile_offsets, binning.tile_counts, tx_n, cfg,
        (0, cfg.num_tiles(cam.width, cam.height)),
    )
    keep = (sigma >= 0.0) & (sigma <= rows[:, COL_BOUND : COL_BOUND + 1])
    ext = tile_raster.splat_extent_torch(rows)
    # `pair_pixel_sigma` lists a tile's pixels row-major
    order = tile_raster.tile_thread_pixels(*tile)
    lane = torch.from_numpy(order[:, 1] * tile[0] + order[:, 0])
    keep, px, py = keep[:, lane], px[:, lane], py[:, lane]
    culled = 0
    rects = tile_raster.tile_warp_rects(*tile)
    for w in range(len(rects)):
        sl = slice(w * 32, (w + 1) * 32)
        # the rectangle of the warp's own pixel centres
        miss = tile_raster.extent_misses_rect(
            ext, px[:, sl].amin(1), px[:, sl].amax(1), py[:, sl].amin(1), py[:, sl].amax(1))
        assert not bool((miss[:, None] & keep[:, sl]).any())
        culled += int(miss.sum())
    dx, dy = px - ext[:, 0:1], py - ext[:, 1:2]
    assert not bool((keep & ~((dx.abs() <= ext[:, 2:3]) & (dy.abs() <= ext[:, 3:4]))).any())
    assert int(keep.sum()) > 10000 and culled > 0.2 * rows.shape[0] * len(rects)


@torch.no_grad()
def test_cpu_wrappers_leave_the_counters_alone():
    """On CPU tensors the wrappers take the plain versions, which cull nothing
    and count nothing: `counters` stays as the caller zeroed it and the results
    are those of a call without it."""
    model = load_gaussians(SCENE, device="cpu")
    cam = Camera.from_lookat((0.0, 1.2, -2.6), (0, 0, 0), (0, 1, 0), 50.0, 64, 48, device="cpu")
    cfg = RenderConfig()
    proj, colors = _project_and_shade(model, cam, cfg)
    opac = _effective_opacities(model, proj, cfg)
    b = bin_gaussians(proj, cam.width, cam.height, cfg, opacities=opac)
    table = tile_raster.build_splat_table(proj, colors, opac, b.order, cfg)
    args = (table, b.pair_gauss, b.tile_offsets, b.tile_counts)
    counters = torch.zeros((cfg.num_tiles(cam.width, cam.height), 2), dtype=torch.int32)
    rgbd, t_final = cuda_raster.raster_forward(*args, cam.width, cam.height, cfg, counters=counters)
    want_rgbd, want_t = cuda_raster.raster_forward(*args, cam.width, cam.height, cfg)
    assert torch.equal(rgbd, want_rgbd) and torch.equal(t_final, want_t)
    gen = torch.Generator().manual_seed(3)
    d_rgbd = torch.randn(rgbd.shape, generator=gen)
    d_t = torch.randn(t_final.shape, generator=gen)
    bwd = (*args, rgbd, t_final, d_rgbd, d_t, cam.width, cam.height, cfg)
    rows = cuda_raster.raster_backward(*bwd, counters=counters)
    assert torch.equal(rows, cuda_raster.raster_backward(*bwd))
    assert rows.shape == (b.pair_gauss.shape[0], cuda_raster.ROW_COLS)
    assert not bool(counters.any())
