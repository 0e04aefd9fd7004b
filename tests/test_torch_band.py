"""The band form of the port, in one process: what each rank of the sharded
path runs on its horizontal band of tile rows, against the JAX functions that
the JAX `render_sharded` runs per band.

  * `bin_gaussians(max_active=, tile_row0=, total_tiles_y=)`: integer-exact
    against JAX on JAX's projection outputs, bands that divide the frame and
    bands that do not, and a tight `max_active` that drops splats;
  * band images of the plain compositor within atol 3e-5 / rtol 1e-4 of JAX
    `tile_raster.render_tiled(tile_row0=...)`, and the band's explicit
    backward (the raster kernels' plain versions) against `jax.grad` of it
    (atol 5e-6 / rtol 3e-3);
  * the kernels' per-warp cull, through its plain mirror, on a band
    (tile_row0 > 0): it never drops a kept step;
  * `render_bands_in_process` (the ranks' functions in one process): the
    single-device image bit for bit and its gradients, both exchanges;
  * `calibrate_render_config(mesh_ndev=4)` and the band plan's capacities.

The JAX `render_sharded` itself is held to the single chip by
tests/test_sharded.py; tests/test_torch_parallel.py runs the port's across
gloo processes, and holds `make_mesh`'s refusals, `pad_to_multiple` and
`local_batch_slice`."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splat_tpu.camera import Camera as JaxCamera
from gaussian_splat_tpu.config import RenderConfig as JaxConfig
from gaussian_splat_tpu.models.gaussians import GaussianModel as JaxModel
from gaussian_splat_tpu.ops import binning as jax_binning
from gaussian_splat_tpu.ops import render as jax_render_ops
from gaussian_splat_tpu.ops import tile_raster as jax_tile
from gaussian_splat_tpu.ops.projection import project_gaussians as jax_project
from gaussian_splat_tpu_torch import convert
from gaussian_splat_tpu_torch.config import RenderConfig as TorchConfig
from gaussian_splat_tpu_torch.io.ply import load_gaussians
from gaussian_splat_tpu_torch.ops import binning, cuda_raster, tile_raster
from gaussian_splat_tpu_torch.ops.projection import ProjectedGaussians
from gaussian_splat_tpu_torch.ops.render import (
    _effective_opacities, _project_and_shade, calibrate_render_config, render,
)
from gaussian_splat_tpu_torch.parallel import sharded_render

IMAGE_ATOL, IMAGE_RTOL = 3e-5, 1e-4
GRAD_ATOL, GRAD_RTOL = 5e-6, 3e-3
SCENE = os.path.join(os.path.dirname(__file__), "golden", "scene.ply")
W = H = 96  # 6 tile rows of 16 px


@functools.lru_cache(maxsize=None)
def _jax_scene(seed=0, n=512, scale_range=(0.02, 0.1)):
    leaves = convert.random_leaves(seed, n, extent=1.2, scale_range=scale_range)
    cam = JaxCamera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, W, H)
    cfg = JaxConfig()
    op = jax.nn.sigmoid(jnp.asarray(leaves["opacity_logits"]))
    proj = jax_project(
        jnp.asarray(leaves["means"]), jnp.asarray(leaves["quats"]),
        jnp.exp(jnp.asarray(leaves["log_scales"])), cam,
        opacities=op, alpha_skip=cfg.alpha_skip,
    )
    colors = jnp.asarray(leaves["sh"][:, 0, :] * 0.28209479177387814 + 0.5).clip(0)
    return proj, colors, op


def _in_band(proj, band_h, band):
    """The sharded path's band test, on the JAX projection (numpy)."""
    my = np.asarray(proj.means2d)[:, 1]
    r = np.ceil(np.asarray(proj.extents)[:, 1] * np.float32(256.0)) * np.float32(1.0 / 256.0)
    lo, hi = np.float32(band * band_h), np.float32((band + 1) * band_h)
    return np.asarray(proj.valid) & (my + r > lo) & (my - r < hi)


def _band_proj(proj, band_h, band):
    return proj._replace(valid=jnp.asarray(_in_band(proj, band_h, band)))


def _to_torch(proj) -> ProjectedGaussians:
    return ProjectedGaussians(*(torch.from_numpy(np.array(x)) for x in proj))


# (bands, band, max_active, global tile rows): 6 tile rows in 2 bands
# (dividing), in 4 bands (padded to 8 rows: the JAX package's global grid,
# whose last band is all padding, and the frame's true 6 rows, which the
# port's render_sharded passes), and a band whose max_active is too tight
BANDS = {
    "2bands-b1": (2, 1, None, 6),
    "4bands-b2-padded": (4, 2, 256, 8),
    "4bands-b3-padded": (4, 3, 512, 8),
    "4bands-b1-true-rows": (4, 1, 384, 6),
    "2bands-b0-tight": (2, 0, 128, 6),
}


@pytest.mark.parametrize("case", list(BANDS))
def test_band_binning_equals_jax(case):
    ndev, band, max_active, total = BANDS[case]
    proj, _, op = _jax_scene()
    rows = -(-6 // ndev)
    band_h, row0 = rows * 16, band * rows
    pb = _band_proj(proj, band_h, band)
    jcfg, tcfg = JaxConfig(), TorchConfig()
    jb = jax.jit(lambda p, o: jax_binning.bin_gaussians(
        p, W, band_h, jcfg, max_active=max_active, tile_row0=jnp.int32(row0),
        total_tiles_y=total, opacities=o))(pb, op)
    tb = binning.bin_gaussians(
        _to_torch(pb), W, band_h, tcfg, opacities=torch.from_numpy(np.array(op)),
        max_active=max_active, tile_row0=row0, total_tiles_y=total,
    )
    for name in ("num_pairs", "overflow", "clamped_rects", "tier_overflow", "dropped_gaussians"):
        assert int(getattr(tb, name)) == int(getattr(jb, name)), name
    m = tb.num_active
    # valid splats past the cap are counted, none silently lost
    assert int(tb.dropped_gaussians) == max(int(pb.valid.sum()) - m, 0)
    assert (int(tb.dropped_gaussians) > 0) == (case in ("2bands-b0-tight", "4bands-b1-true-rows"))
    assert m == min(max_active or 512, 512)
    np.testing.assert_array_equal(tb.order.numpy(), np.asarray(jb.order))
    np.testing.assert_array_equal(tb.tile_offsets.numpy(), np.asarray(jb.tile_offsets))
    np.testing.assert_array_equal(tb.tile_counts.numpy(), np.asarray(jb.tile_counts))
    # the port keeps the m active ranks; JAX's ranks past them hold no pair
    jrs = np.asarray(jb.rank_starts)
    np.testing.assert_array_equal(tb.rank_starts.numpy(), jrs[: m + 1])
    assert (jrs[m:] == jrs[m]).all()
    num_tiles = tcfg.num_tiles(W, band_h)
    j_tile, t_tile = np.asarray(jb.pair_tile), tb.pair_tile.numpy()
    j_valid, t_valid = j_tile < num_tiles, t_tile < num_tiles
    np.testing.assert_array_equal(t_tile[t_valid], j_tile[j_valid])
    np.testing.assert_array_equal(tb.pair_gauss.numpy()[t_valid], np.asarray(jb.pair_gauss)[j_valid])
    assert int(t_valid.sum()) == int(tb.num_pairs) - int(tb.overflow)
    # the last of 4 bands over 6 rows is padding: it holds no pair
    assert (int(tb.num_pairs) == 0) == (case == "4bands-b3-padded")
    # the slot layout is emission_rows(m): the rank order the rank_perm
    # kernel's rule (its plain version) reads from binning's sort and the
    # band's kept cells is the rank sort's, element for element
    perm = cuda_raster.rank_permutation_from_sort(tb.pair_src, tb.rank_starts, tb.kept, tcfg)
    assert torch.equal(perm, tile_raster.rank_permutation(tb.pair_gauss, tb.rank_starts, m))
    assert binning.emission_rows(m, tcfg).small == m


def test_max_active_parity_and_drop_accounting():
    """max_active >= #valid: bitwise the uncapped image, dropped == 0;
    max_active < #valid: dropped counts exactly the overflow (the JAX
    package's test_max_active_parity_and_drop_accounting)."""
    proj, colors, op = _jax_scene()
    tp = _to_torch(proj)
    tc, top = torch.from_numpy(np.array(colors)), torch.from_numpy(np.array(op))
    cfg = TorchConfig()
    full = tile_raster.render_tiled(tp, tc, top, W, H, cfg)
    capped = tile_raster.render_tiled(tp, tc, top, W, H, cfg, max_active=512)
    assert torch.equal(full[0], capped[0]) and int(capped[3].dropped_gaussians) == 0
    n_valid = int(tp.valid.sum())
    assert n_valid > 128
    tight = tile_raster.render_tiled(tp, tc, top, W, H, cfg, max_active=128)
    assert int(tight[3].dropped_gaussians) == n_valid - 128


def test_band_pair_list_is_a_fraction_of_the_single_device_s():
    """The per-band pair list (the sort's size) scales ~1/D, not O(N) (the JAX
    package's test_sharded_pair_sort_is_fraction_of_single_chip)."""
    model = convert.model_from_numpy(
        convert.random_leaves(0, 4096, extent=1.2, scale_range=(0.02, 0.1)), "cpu")
    cam = convert.camera_from_numpy(
        np.asarray(JaxCamera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, 256, 256)
                   .viewmat), *_intrinsics_at(256, 256), 256, 256, device="cpu")
    cfg = TorchConfig()
    with torch.no_grad():
        proj, _ = _project_and_shade(model, cam, cfg)
    full = binning.bin_gaussians(proj, 256, 256, cfg)
    ndev = 8
    cap = -(-4096 * 2 // ndev // cfg.chunk_size) * cfg.chunk_size
    band = binning.bin_gaussians(proj, 256, 256 // ndev, cfg, max_active=cap,
                                 tile_row0=2, total_tiles_y=16)
    assert band.pair_tile.shape[0] <= full.pair_tile.shape[0] * 2 // ndev


@pytest.mark.parametrize("case", ["2bands-b1", "4bands-b1-true-rows"])
def test_band_image_equals_jax_render_tiled(case):
    ndev, band, max_active, total = BANDS[case]
    proj, colors, op = _jax_scene()
    rows = -(-6 // ndev)
    band_h, row0 = rows * 16, band * rows
    pb = _band_proj(proj, band_h, band)
    want = jax.jit(lambda p, c, o: jax_tile.render_tiled(
        p, c, o, W, band_h, JaxConfig(background=(0.2, 0.1, 0.4)), max_active=max_active,
        tile_row0=jnp.int32(row0), total_tiles_y=total))(pb, colors, op)
    got = tile_raster.render_tiled(
        _to_torch(pb), torch.from_numpy(np.array(colors)), torch.from_numpy(np.array(op)),
        W, band_h, TorchConfig(background=(0.2, 0.1, 0.4)), max_active=max_active,
        tile_row0=row0, total_tiles_y=total,
    )
    for g, w, what in zip(got[:3], want, ("image", "t_final", "depth")):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=IMAGE_ATOL,
                                   rtol=IMAGE_RTOL, err_msg=what)
    assert float(1.0 - got[1].min()) > 0.3  # the band holds real content


def test_band_explicit_backward_equals_jax_grad():
    """The raster kernels' plain versions with tile_row0 = 2 (the backward
    by the explicit formulas, through `cuda_raster.rasterize`) against
    `jax.grad` of JAX render_tiled on the same band."""
    proj, colors, op = _jax_scene()
    band_h, row0, total = 32, 2, 6
    pb = _band_proj(proj, band_h, 1)
    weights = np.random.default_rng(5).standard_normal((band_h, W, 3)).astype(np.float32)
    jcfg, tcfg = JaxConfig(), TorchConfig()

    def jax_loss(means2d, conics, colors, op):
        img, t_final, depth = jax_tile.render_tiled(
            pb._replace(means2d=means2d, conics=conics), colors, op, W, band_h, jcfg,
            max_active=256, tile_row0=jnp.int32(row0), total_tiles_y=total)
        return jnp.mean(img * weights) + 0.1 * jnp.mean(depth) + 0.1 * jnp.mean(t_final)

    want = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2, 3)))(pb.means2d, pb.conics, colors, op)
    leaves = [torch.from_numpy(np.array(x)).requires_grad_()
              for x in (pb.means2d, pb.conics, colors, op)]
    tp = _to_torch(pb)._replace(means2d=leaves[0], conics=leaves[1])
    img, t_final, depth, _ = tile_raster.render_tiled(
        tp, leaves[2], leaves[3], W, band_h, tcfg, raster_fn=cuda_raster.rasterize,
        max_active=256, tile_row0=row0, total_tiles_y=total)
    (torch.mean(img * torch.from_numpy(weights)) + 0.1 * torch.mean(depth)
     + 0.1 * torch.mean(t_final)).backward()
    for leaf, w, what in zip(leaves, want, ("means2d", "conics", "colors", "opacities")):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=what)
        assert float(np.abs(np.asarray(w)).max()) > 10 * GRAD_ATOL, what


@torch.no_grad()
def test_band_cull_never_drops_a_kept_step():
    """The golden scene's band 1 of 2 (tile_row0 = 4): each warp's rectangle
    in global coordinates (`warp_pixel_rects`) against the keep mask of
    `pair_pixel_sigma` with the band's offset, over every tile's segment."""
    model = load_gaussians(SCENE, device="cpu")
    cam = convert.camera_from_numpy(
        np.asarray(JaxCamera.from_lookat((0.0, 1.2, -2.6), (0, 0, 0), (0, 1, 0), 50.0, 160, 128)
                   .viewmat), *_intrinsics(160, 128), 160, 128, device="cpu")
    cfg = TorchConfig()
    proj, colors = _project_and_shade(model, cam, cfg)
    opac = _effective_opacities(model, proj, cfg)
    band_h, row0 = 64, 4
    b = binning.bin_gaussians(proj, cam.width, band_h, cfg, opacities=opac,
                              tile_row0=row0, total_tiles_y=8)
    table = tile_raster.build_splat_table(proj, colors, opac, b.order, cfg)
    tx_n = cfg.tiles_x(cam.width)
    rows, local_tile, _, px, py, sigma = tile_raster.pair_pixel_sigma(
        table, b.pair_gauss, b.tile_offsets, b.tile_counts, tx_n, cfg,
        (0, cfg.num_tiles(cam.width, band_h)), row0,
    )
    assert float(py.min()) >= row0 * 16 + 0.5  # global pixel centres
    keep = (sigma >= 0.0) & (sigma <= rows[:, tile_raster.COL_BOUND : tile_raster.COL_BOUND + 1])
    ext = tile_raster.splat_extent_torch(rows)
    x0, x1, y0, y1 = tile_raster.warp_pixel_rects(local_tile, tx_n, 32, 16, row0)
    miss = tile_raster.extent_misses_rect(ext[:, None, :], x0, x1, y0, y1)  # (pairs, warps)
    order = tile_raster.tile_thread_pixels(32, 16)
    lane = torch.from_numpy(order[:, 1] * 32 + order[:, 0])
    keep = keep[:, lane].view(keep.shape[0], -1, 32)  # (pairs, warps, 32), kernel layout
    assert not bool((miss[..., None] & keep).any())
    # each warp's rectangle holds its pixels: the layout and the offset agree
    pyw = py[:, lane].view(py.shape[0], -1, 32)
    assert bool(((pyw >= y0[..., None]) & (pyw <= y1[..., None])).all())
    assert int(keep.sum()) > 5000 and int(miss.sum()) > 0.2 * miss.numel()


def _intrinsics(width, height):
    jc = JaxCamera.from_lookat((0.0, 1.2, -2.6), (0, 0, 0), (0, 1, 0), 50.0, width, height)
    return jc.fx, jc.fy, jc.cx, jc.cy


def _intrinsics_at(width, height):
    """Intrinsics of the tests' camera at (0, 0, -4), 60°."""
    jc = JaxCamera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, width, height)
    return jc.fx, jc.fy, jc.cx, jc.cy


@pytest.mark.parametrize("exchange", ["all_gather", "all_to_all"])
def test_bands_in_process_equal_the_single_device_render(exchange):
    """`render_bands_in_process`: the ranks' pack / exchange / render-one-band
    functions for 4 bands (6 tile rows, padded to 8) in one process — the
    single-device frame bit for bit, every sentinel 0, and the gradients of
    the single device (autograd sums what the collectives' transposes sum)."""
    leaves = convert.random_leaves(2, 256, sh_degree=1, extent=1.2, scale_range=(0.02, 0.1))
    model = convert.model_from_numpy(leaves, "cpu")
    cam = convert.camera_from_numpy(
        np.asarray(JaxCamera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, W, H).viewmat),
        *_intrinsics_at(W, H), W, H, device="cpu")
    cfg = TorchConfig(shard_exchange=exchange, background=(0.2, 0.1, 0.4))
    weights = torch.from_numpy(np.random.default_rng(1).standard_normal((H, W, 3)).astype(np.float32))
    out = sharded_render.render_bands_in_process(model, cam, cfg, 4)
    (out.image * weights).mean().backward()
    got = {k: getattr(model, k).grad.clone() for k in model.LEAVES}
    model.zero_grad()
    single = render(model, cam, cfg)
    (single.image * weights).mean().backward()
    assert torch.equal(out.image, single.image)
    assert torch.equal(1.0 - out.t_final, single.alpha) and torch.equal(out.depth, single.depth)
    for k in ("overflow", "tier_overflow", "dropped_gaussians"):
        assert getattr(out.stats, k).tolist() == [0] * 4, k
    assert int(out.stats.num_pairs.sum()) >= int(single.stats.num_pairs) > 0
    for k in model.LEAVES:
        np.testing.assert_allclose(got[k].numpy(), getattr(model, k).grad.numpy(),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=k)


def test_calibrate_mesh_margin_equals_jax():
    leaves = convert.random_leaves(4, 600, sh_degree=1, extent=1.2, scale_range=(0.02, 0.3))
    jc = JaxCamera.from_lookat((0, 0.5, -4), (0, 0, 0), (0, 1, 0), 60.0, 128, 96)
    jcfg = jax_render_ops.calibrate_render_config(
        JaxModel.create(**leaves), jc, JaxConfig(), mesh_ndev=4)
    cam = convert.camera_from_numpy(np.asarray(jc.viewmat), jc.fx, jc.fy, jc.cx, jc.cy,
                                    128, 96, device="cpu")
    tcfg = calibrate_render_config(convert.model_from_numpy(leaves, "cpu"), cam, TorchConfig(),
                                   mesh_ndev=4)
    assert 0.0 < tcfg.shard_capacity_margin == jcfg.shard_capacity_margin
    assert tcfg.pairs_per_gaussian == jcfg.pairs_per_gaussian
    assert tcfg.big_tier_capacity == jcfg.big_tier_capacity


def test_band_plan_capacities():
    """The capacities of the JAX render_sharded's body, for both exchanges."""
    cfg = TorchConfig()
    plan = sharded_render.band_plan(cfg, 1_000_000, 1080, 4)
    assert (plan.rows_per_dev, plan.band_h, plan.padded_h, plan.total_tiles_y) == (17, 272, 1088, 68)
    assert plan.max_active == -(-(250_000 + 250_000) // 128) * 128
    assert plan.a2a_cap == 250_000
    small = sharded_render.band_plan(cfg, 512, 96, 4)
    assert (small.rows_per_dev, small.padded_h, small.total_tiles_y) == (2, 128, 6)
    assert small.max_active == 512 and small.a2a_cap == 128
