"""Port bin_gaussians vs JAX bin_gaussians: exact integer equality.

The port is fed the JAX projection's OUTPUTS, so a last-bit difference
upstream cannot pass for a binning fault."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splat_tpu.camera import Camera as JaxCamera
from gaussian_splat_tpu.config import RenderConfig as JaxConfig
from gaussian_splat_tpu.ops import binning as jax_binning
from gaussian_splat_tpu.ops.projection import project_gaussians as jax_project
from gaussian_splat_tpu_torch import convert
from gaussian_splat_tpu_torch.config import RenderConfig as TorchConfig
from gaussian_splat_tpu_torch.ops import binning as torch_binning
from gaussian_splat_tpu_torch.ops.projection import ProjectedGaussians


def _jax_projection(seed, n, width, height, scale_range, eye=(0, 0, -4)):
    leaves = convert.random_leaves(seed, n, extent=1.2, scale_range=scale_range)
    cam = JaxCamera.from_lookat(eye, (0, 0, 0), (0, 1, 0), 60.0, width, height)
    op = jax.nn.sigmoid(jnp.asarray(leaves["opacity_logits"]))
    proj = jax_project(
        jnp.asarray(leaves["means"]), jnp.asarray(leaves["quats"]),
        jnp.exp(jnp.asarray(leaves["log_scales"])), cam,
        opacities=op, alpha_skip=1.0 / 255.0,
    )
    return proj, op


def _to_torch(proj) -> ProjectedGaussians:
    return ProjectedGaussians(
        *(torch.from_numpy(np.array(x)) for x in proj)
    )


def _compare(jb, tb, num_tiles):
    for name in ("num_pairs", "overflow", "clamped_rects", "tier_overflow"):
        assert int(getattr(tb, name)) == int(getattr(jb, name)), name
    np.testing.assert_array_equal(tb.order.numpy(), np.asarray(jb.order))
    np.testing.assert_array_equal(tb.tile_offsets.numpy(), np.asarray(jb.tile_offsets))
    np.testing.assert_array_equal(tb.tile_counts.numpy(), np.asarray(jb.tile_counts))
    np.testing.assert_array_equal(tb.rank_starts.numpy(), np.asarray(jb.rank_starts))
    j_tile = np.asarray(jb.pair_tile)
    t_tile = tb.pair_tile.numpy()
    j_valid, t_valid = j_tile < num_tiles, t_tile < num_tiles
    np.testing.assert_array_equal(t_tile[t_valid], j_tile[j_valid])
    np.testing.assert_array_equal(
        tb.pair_gauss.numpy()[t_valid], np.asarray(jb.pair_gauss)[j_valid]
    )
    assert not t_valid[int(t_valid.sum()):].any()  # padding only at the end
    assert int(t_valid.sum()) == int(tb.num_pairs) - int(tb.overflow)
    for t in (tb.pair_gauss, tb.pair_tile, tb.tile_offsets, tb.tile_counts,
              tb.rank_starts):
        assert t.dtype == torch.int32


CASES = {
    # plain scenes, every sentinel 0
    "default-seed0": dict(seed=0, n=120, cfg={}),
    "default-seed1": dict(seed=1, n=200, cfg={}),
    # big splats close to the camera: the K-cap shrink fires
    "kcap-shrink": dict(seed=2, n=60, scale_range=(0.3, 0.9), eye=(0, 0, -2.5),
                        cfg=dict(max_tiles_per_gaussian=8, small_tiles_per_gaussian=3),
                        expect="clamped_rects"),
    # tiny pair budget: whole far gaussians are dropped
    "budget-overflow": dict(seed=3, n=4200, scale_range=(0.02, 0.1),
                            cfg=dict(pairs_per_gaussian=0.5), expect="overflow"),
    # big tier too small: eligible splats lose their slot by area, ties by index
    "tier-overflow": dict(seed=4, n=150, scale_range=(0.3, 0.9), eye=(0, 0, -2.5),
                          cfg=dict(big_tier_capacity=5), expect="tier_overflow"),
    # other tile shape
    "tiles-16x16": dict(seed=5, n=120, cfg=dict(tile_width=16, tile_height=16)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_binning_equals_jax(case):
    c = CASES[case]
    width, height = 96, 64
    proj, op = _jax_projection(
        c["seed"], c["n"], width, height, c.get("scale_range", (0.02, 0.1)),
        c.get("eye", (0, 0, -4)),
    )
    jcfg, tcfg = JaxConfig(**c["cfg"]), TorchConfig(**c["cfg"])
    jb = jax.jit(
        lambda p, o: jax_binning.bin_gaussians(p, width, height, jcfg, opacities=o)
    )(proj, op)
    tb = torch_binning.bin_gaussians(
        _to_torch(proj), width, height, tcfg, opacities=torch.from_numpy(np.array(op))
    )
    if "expect" in c:
        assert int(getattr(jb, c["expect"])) > 0, "case does not exercise its path"
    _compare(jb, tb, tcfg.num_tiles(width, height))


def test_binning_without_cell_test_equals_jax():
    proj, _ = _jax_projection(6, 120, 96, 64, (0.02, 0.2))
    jb = jax_binning.bin_gaussians(proj, 96, 64, JaxConfig())
    tb = torch_binning.bin_gaussians(_to_torch(proj), 96, 64, TorchConfig())
    _compare(jb, tb, TorchConfig().num_tiles(96, 64))


def test_rect_helpers_equal_jax():
    proj, _ = _jax_projection(7, 150, 96, 64, (0.05, 0.5), eye=(0, 0, -3))
    tp = _to_torch(proj)
    for use_extents in (True, False):
        j = jax_binning.tile_rects(
            proj.means2d, proj.radii, proj.valid, 96, 64, JaxConfig(),
            extents=proj.extents if use_extents else None,
        )
        t = torch_binning.tile_rects(
            tp.means2d, tp.radii, tp.valid, 96, 64, TorchConfig(),
            extents=tp.extents if use_extents else None,
        )
        valid = np.asarray(proj.valid)
        for a, b in zip(t[:4], j[:4]):
            np.testing.assert_array_equal(a.numpy()[valid], np.asarray(b)[valid])
        assert int(t[4]) == int(j[4])
    x = np.linspace(0.0, 37.3, 101, dtype=np.float32)
    np.testing.assert_array_equal(
        torch_binning.quantize_extent_up(torch.from_numpy(x)).numpy(),
        np.asarray(jax_binning.quantize_extent_up(jnp.asarray(x))),
    )
