"""The modules that hold the backward kernels, on the CPU: the raster stage's
explicit backward (the plain versions of raster_bwd and segsum behind
`cuda_raster.rasterize`) against autograd through the plain compositor and
against the JAX `jnp_tile` gradients (tests/test_torch_raster_bwd_pallas.py
holds it against the Pallas kernels in interpret mode).

Inputs are JAX's projection of a numpy-seeded scene, handed to both sides, so
a difference is the raster stage's alone. The loss mixes image, depth and
alpha (a non-zero T_final cotangent) with seeded weights, scaled like a mean
over the image so that the reference suite's gradient tolerance applies
(atol 5e-6 / rtol 3e-3, tests/test_pallas.py:60-64,240)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splat_tpu.camera import Camera as JaxCamera
from gaussian_splat_tpu.config import RenderConfig as JaxConfig
from gaussian_splat_tpu.ops import pallas_raster as jax_pallas
from gaussian_splat_tpu.ops import tile_raster as jax_tile
from gaussian_splat_tpu.ops.projection import project_gaussians as jax_project
from gaussian_splat_tpu_torch import convert
from gaussian_splat_tpu_torch.config import RenderConfig as TorchConfig
from gaussian_splat_tpu_torch.ops import cuda_raster, tile_raster
from gaussian_splat_tpu_torch.ops.binning import bin_gaussians
from gaussian_splat_tpu_torch.ops.projection import ProjectedGaussians

ATOL, RTOL = 5e-6, 3e-3
STAGE_INPUTS = ("means2d", "conics", "colors", "depths", "opacities")


def _leaves(kind, seed):
    if kind == "random":
        return convert.random_leaves(seed, 100, extent=1.2, scale_range=(0.02, 0.1))
    rng = np.random.default_rng(seed)
    if kind == "deep":  # dim splats stacked in one tile: a long segment
        n = 150
        leaves = dict(
            means=0.05 * rng.standard_normal((n, 3)),
            log_scales=np.full((n, 3), np.log(0.02)),
            opacity_logits=np.full((n,), -2.0),
        )
    elif kind == "corner":  # a few splats in a corner: most tiles are empty
        n = 3
        leaves = dict(
            means=np.array([[1.2, 0.9, 0.0], [1.1, 0.8, 0.2], [1.25, 0.85, -0.1]]),
            log_scales=np.full((n, 3), np.log(0.08)),
            opacity_logits=np.full((n,), 2.0),
        )
    elif kind == "saturated":  # opaque near splat hides a far cluster
        n = 100
        leaves = dict(
            means=np.concatenate(
                [[[0.0, 0.0, -1.0]], 0.1 * rng.standard_normal((n - 1, 3)) + [[0, 0, 1.0]]]
            ),
            log_scales=np.full((n, 3), np.log(0.3)),
            opacity_logits=np.concatenate([[12.0], np.full(n - 1, 2.0)]),
        )
    leaves["quats"] = np.tile([1.0, 0.0, 0.0, 0.0], (n, 1))
    leaves["sh"] = rng.uniform(-0.5, 1.5, (n, 1, 3))
    return {k: np.asarray(v, np.float32) for k, v in leaves.items()}


@functools.lru_cache(maxsize=None)
def _stage(kind, seed, width, height):
    """JAX projection of the scene, the raster stage's five inputs as numpy,
    and the loss weights."""
    leaves = _leaves(kind, seed)
    cfg = JaxConfig()
    cam = JaxCamera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, width, height)
    op = jax.nn.sigmoid(jnp.asarray(leaves["opacity_logits"]))
    proj = jax_project(
        jnp.asarray(leaves["means"]), jnp.asarray(leaves["quats"]),
        jnp.exp(jnp.asarray(leaves["log_scales"])), cam,
        opacities=op, alpha_skip=cfg.alpha_skip,
    )
    colors = jnp.asarray(leaves["sh"][:, 0, :] * 0.28209479177387814 + 0.5).clip(0)
    inputs = dict(
        means2d=np.asarray(proj.means2d), conics=np.asarray(proj.conics),
        colors=np.asarray(colors), depths=np.asarray(proj.depths),
        opacities=np.asarray(op),
    )
    rng = np.random.default_rng(100 + seed)
    scale = 1.0 / (width * height)
    weights = dict(
        image=(scale * rng.standard_normal((height, width, 3))).astype(np.float32),
        depth=(scale * rng.standard_normal((height, width))).astype(np.float32),
        alpha=(scale * rng.standard_normal((height, width))).astype(np.float32),
    )
    return proj, inputs, weights


def _loss(image, t_final, depth, weights, lib):
    return (
        lib.sum(image * weights["image"]) + lib.sum(depth * weights["depth"])
        + lib.sum((1.0 - t_final) * weights["alpha"])
    )


def _jax_grads(backend, kind, seed, width, height, **cfg_kw):
    proj, inputs, weights = _stage(kind, seed, width, height)
    cfg = JaxConfig(exact_vjp=True, **cfg_kw)
    wj = {k: jnp.asarray(v) for k, v in weights.items()}

    def loss(means2d, conics, colors, depths, opacities):
        p = proj._replace(means2d=means2d, conics=conics, depths=depths)
        if backend == "pallas":
            out = jax_pallas.render_tiled_pallas(
                p, colors, opacities, width, height, cfg, interpret=True
            )
        else:
            out = jax_tile.render_tiled(p, colors, opacities, width, height, cfg)
        image, t_final, depth = out
        return _loss(image, t_final, depth, wj, jnp)

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        *(jnp.asarray(inputs[k]) for k in STAGE_INPUTS)
    )
    return dict(zip(STAGE_INPUTS, (np.asarray(g) for g in grads)))


def _torch_grads(explicit, kind, seed, width, height, **cfg_kw):
    """Gradients through the port's tiled render: `explicit` takes the raster
    stage through `cuda_raster.rasterize` (the explicit backward), otherwise
    autograd differentiates the plain compositor."""
    proj, inputs, weights = _stage(kind, seed, width, height)
    cfg = TorchConfig(**cfg_kw)
    t_in = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in inputs.items()}
    tproj = ProjectedGaussians(*(torch.from_numpy(np.array(x)) for x in proj))._replace(
        means2d=t_in["means2d"], conics=t_in["conics"], depths=t_in["depths"]
    )
    image, t_final, depth, _ = tile_raster.render_tiled(
        tproj, t_in["colors"], t_in["opacities"], width, height, cfg,
        raster_fn=cuda_raster.rasterize if explicit else None,
    )
    wt = {k: torch.from_numpy(v) for k, v in weights.items()}
    _loss(image, t_final, depth, wt, torch).backward()
    return {k: t_in[k].grad.numpy() for k in STAGE_INPUTS}


def _assert_grads_close(got, want, what):
    for k in STAGE_INPUTS:
        assert np.isfinite(got[k]).all(), (what, k)
        np.testing.assert_allclose(
            got[k], want[k], atol=ATOL, rtol=RTOL, err_msg=f"{what}: d{k}"
        )
    # the comparison is not vacuous: gradients stand well above atol
    assert max(float(np.abs(want[k]).max()) for k in STAGE_INPUTS) > 100 * ATOL, what


CASES = [
    # kind, seed, width, height, config overrides
    ("random", 0, 96, 64, {}),
    ("deep", 5, 64, 64, {}),
    ("corner", 0, 96, 64, {}),
    ("saturated", 1, 64, 64, {}),
    ("saturated", 1, 64, 64, {"sat_check": False}),
    ("random", 1, 100, 70, {"tile_width": 16, "tile_height": 16}),
]
IDS = ["random", "deep", "empty_tiles", "saturated", "saturated_no_sat_check", "ragged_16x16"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_explicit_backward_matches_autograd_and_jnp_tile(case):
    kind, seed, width, height, kw = case
    explicit = _torch_grads(True, kind, seed, width, height, **kw)
    _assert_grads_close(
        explicit, _torch_grads(False, kind, seed, width, height, **kw), "autograd"
    )
    _assert_grads_close(
        explicit, _jax_grads("jnp_tile", kind, seed, width, height, **kw), "jnp_tile"
    )


def _raster_args(kind, seed, width, height, cfg):
    proj, inputs, _ = _stage(kind, seed, width, height)
    tproj = ProjectedGaussians(*(torch.from_numpy(np.array(x)) for x in proj))
    colors = torch.from_numpy(inputs["colors"].copy())
    op = torch.from_numpy(inputs["opacities"].copy())
    b = bin_gaussians(tproj, width, height, cfg, opacities=op)
    table = tile_raster.build_splat_table(tproj, colors, op, b.order, cfg)
    return table, b


def test_backward_rows_batches_walked_and_padding():
    """`raster_backward_torch`: batches of a few pairs equal one batch (the
    deep tile spans many); rows of padding pairs are zero; `walked` cuts a
    segment short and zeroes the rows behind the cut."""
    width = height = 64
    cfg = TorchConfig()
    table, b = _raster_args("deep", 5, width, height, cfg)
    args = (table, b.pair_gauss, b.tile_offsets, b.tile_counts)
    assert int(b.tile_counts.max()) > 100
    rgbd, t_final = tile_raster.raster_forward_torch(*args, width, height, cfg)
    gen = torch.Generator().manual_seed(0)
    d_rgbd = torch.randn(rgbd.shape, generator=gen)
    d_t = torch.randn(t_final.shape, generator=gen)
    bwd = functools.partial(
        tile_raster.raster_backward_torch, *args, rgbd, t_final, d_rgbd, d_t,
        width, height, cfg,
    )
    rows = bwd()
    total = int(b.rank_starts[-1])
    assert rows.shape == (b.pair_gauss.shape[0], 10) and total < rows.shape[0]
    assert not rows[total:].any() and rows[:total].abs().max() > 1e-3
    small = bwd(max_batch_pairs=7)
    scale = rows.abs().amax(0, keepdim=True)
    assert ((rows - small).abs() <= 1e-4 * rows.abs() + 2e-6 * scale).all()
    # the wrapper pads the rows to the table's layout
    rows12 = cuda_raster.raster_backward(
        *args, rgbd, t_final, d_rgbd, d_t, width, height, cfg
    )
    assert rows12.shape[1] == 12 and not rows12[:, 10:].any()
    assert torch.equal(rows12[:, :10], rows)

    # cut the deepest tile after 40 pairs, as an early exit would
    deep_tile = int(b.tile_counts.argmax())
    walked = b.tile_counts.clone()
    walked[deep_tile] = 40
    off, cnt = int(b.tile_offsets[deep_tile]), int(b.tile_counts[deep_tile])
    cut_counts = b.tile_counts.clone()
    cut_counts[deep_tile] = 40
    # forward results of the cut scene: the tile composited from 40 pairs only
    keep = torch.ones(b.pair_gauss.shape[0], dtype=torch.bool)
    keep[off + 40 : off + cnt] = False
    cut_offsets = torch.cumsum(cut_counts, 0, dtype=torch.int32) - cut_counts
    cut_args = (table, b.pair_gauss[keep].contiguous(), cut_offsets, cut_counts)
    rgbd_c, t_c = tile_raster.raster_forward_torch(*cut_args, width, height, cfg)
    want = tile_raster.raster_backward_torch(
        *cut_args, rgbd_c, t_c, d_rgbd, d_t, width, height, cfg
    )
    got = tile_raster.raster_backward_torch(
        *args, rgbd_c, t_c, d_rgbd, d_t, width, height, cfg, walked=walked
    )
    assert not got[off + 40 : off + cnt].any()
    n_kept = int(keep.sum())
    np.testing.assert_allclose(
        got[keep].numpy()[:n_kept], want.numpy()[:n_kept], rtol=1e-5, atol=1e-6
    )


@pytest.mark.parametrize("n,b_rows,seed", [(7, 40, 0), (50, 33, 1), (3, 9, 2)])
def test_segment_sum_against_a_loop(n, b_rows, seed):
    """`rank_permutation` + `segment_sum_torch` against a numpy loop, with
    padding rows (which must not be counted) and ranks that have no pair."""
    rng = np.random.default_rng(seed)
    real = b_rows - 6  # six padding rows at the end of the pair list
    ranks = rng.integers(0, n, size=real)
    ranks[ranks == 1] = 0  # rank 1 stays empty
    pair_gauss = np.concatenate([ranks, np.zeros(6, np.int64)]).astype(np.int32)
    counts = np.bincount(ranks, minlength=n)
    rank_starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    rows = rng.standard_normal((b_rows, 12)).astype(np.float32)  # padding rows hold junk

    want = np.zeros((n, 12), np.float32)
    for i in range(real):
        want[ranks[i]] += rows[i]

    perm = tile_raster.rank_permutation(
        torch.from_numpy(pair_gauss), torch.from_numpy(rank_starts), n
    )
    assert perm.dtype == torch.int32
    assert sorted(perm.tolist()) == list(range(b_rows))
    assert perm[:real].tolist() == np.argsort(ranks, kind="stable").tolist()
    for fn in (tile_raster.segment_sum_torch, cuda_raster.segment_sum):
        got = fn(torch.from_numpy(rows), perm, torch.from_numpy(rank_starts), n)
        assert got.shape == (n, 12) and not got[1].any()
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_function_returns_the_table_gradient_only():
    """The Function differentiates the table and nothing else; a second
    backward over the same graph gives the same gradient, bit for bit."""
    cfg = TorchConfig()
    table, b = _raster_args("random", 0, 96, 64, cfg)
    table = table.clone().requires_grad_()
    rgbd, t_final = cuda_raster.rasterize(table, b, 96, 64, cfg)
    assert rgbd.shape == (64, 96, 4) and t_final.shape == (64, 96)
    loss = rgbd.square().sum() + t_final.sum()
    (g1,) = torch.autograd.grad(loss, table, retain_graph=True)
    (g2,) = torch.autograd.grad(loss, table)
    assert g1.shape == table.shape and torch.equal(g1, g2)
    assert not g1[:, 10:].any() and float(g1[:, :10].abs().max()) > 0
    # a frame rendered without autograd saves nothing and still renders
    with torch.no_grad():
        again = cuda_raster.rasterize(table, b, 96, 64, cfg)
    assert torch.equal(again[0], rgbd)
