"""The module that holds the kernel: the port's torch tile compositor (the CUDA
kernel's plain version) vs the JAX Pallas forward kernel in interpret mode and
vs the JAX jnp compositor, on the SAME pair list (JAX's binning output)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splat_tpu.camera import Camera as JaxCamera
from gaussian_splat_tpu.config import RenderConfig as JaxConfig
from gaussian_splat_tpu.ops import binning as jax_binning
from gaussian_splat_tpu.ops import pallas_raster as jax_pallas
from gaussian_splat_tpu.ops import tile_raster as jax_tile
from gaussian_splat_tpu.ops.projection import project_gaussians as jax_project
from gaussian_splat_tpu_torch import convert
from gaussian_splat_tpu_torch.config import RenderConfig as TorchConfig
from gaussian_splat_tpu_torch.ops import binning, cuda_raster, tile_raster
from gaussian_splat_tpu_torch.ops.projection import ProjectedGaussians
from gaussian_splat_tpu_torch.ops.render import render as torch_render

ATOL, RTOL = 3e-5, 1e-4  # the reference suite's own kernel-vs-oracle tolerance


def _scene(kind, seed=0):
    """numpy leaves + image size for the named scene."""
    if kind == "random":
        return convert.random_leaves(seed, 120, extent=1.2, scale_range=(0.02, 0.1)), 96, 64
    rng = np.random.default_rng(seed)
    if kind == "deep":  # 200 dim splats stacked in one tile: multi-chunk segment
        n = 200
        leaves = dict(
            means=0.05 * rng.standard_normal((n, 3)),
            log_scales=np.full((n, 3), np.log(0.02)),
            opacity_logits=np.full((n,), -2.0),
        )
    elif kind == "corner":  # one splat in a corner: most tiles are empty
        n = 1
        leaves = dict(
            means=np.array([[1.2, 0.9, 0.0]]),
            log_scales=np.full((n, 3), np.log(0.08)),
            opacity_logits=np.full((n,), 2.0),
        )
    elif kind == "saturated":  # opaque near splat hides a far cluster
        n = 150
        leaves = dict(
            means=np.concatenate(
                [[[0.0, 0.0, -1.0]], 0.1 * rng.standard_normal((n - 1, 3)) + [[0, 0, 1.0]]]
            ),
            log_scales=np.full((n, 3), np.log(0.3)),
            opacity_logits=np.concatenate([[12.0], np.full(n - 1, 2.0)]),
        )
    leaves["quats"] = np.tile([1.0, 0.0, 0.0, 0.0], (n, 1))
    leaves["sh"] = rng.uniform(-0.5, 1.5, (n, 1, 3))
    size = (128, 96) if kind == "corner" else (64, 64)
    return {k: np.asarray(v, np.float32) for k, v in leaves.items()}, *size


def _jax_stage(leaves, width, height, sat_check=True):
    """JAX projection + binning, and both JAX compositors' tile outputs."""
    cfg = JaxConfig(sat_check=sat_check)
    cam = JaxCamera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, width, height)
    op = jax.nn.sigmoid(jnp.asarray(leaves["opacity_logits"]))
    proj = jax_project(
        jnp.asarray(leaves["means"]), jnp.asarray(leaves["quats"]),
        jnp.exp(jnp.asarray(leaves["log_scales"])), cam,
        opacities=op, alpha_skip=cfg.alpha_skip,
    )
    colors = jnp.asarray(leaves["sh"][:, 0, :] * 0.28209479177387814 + 0.5).clip(0)
    tx_n, ty_n = cfg.tiles_x(width), cfg.tiles_y(height)
    num_tiles = tx_n * ty_n

    @jax.jit
    def run(proj, colors, op):
        b = jax_binning.bin_gaussians(proj, width, height, cfg, opacities=op)
        table10 = jnp.concatenate(
            [proj.means2d, proj.conics, colors, proj.depths[:, None], op[:, None]],
            axis=1,
        )[b.order]
        valid_p = b.pair_tile < num_tiles
        rows = table10[b.pair_gauss]
        jnp_rgbd, jnp_t = jax_tile.composite_pairs(
            b.pair_tile, rows[:, 0:2], rows[:, 2:5], rows[:, 5:9], rows[:, 9],
            valid_p, b.tile_offsets, tx_n, num_tiles, cfg,
        )
        static = jax_pallas.RasterStatics(
            tile_w=cfg.tile_width, tile_h=cfg.tile_height, tiles_x=tx_n,
            tiles_y=ty_n, chunk=cfg.chunk_size, alpha_clamp=cfg.alpha_clamp,
            alpha_skip=cfg.alpha_skip, sigma_cutoff=cfg.sigma_cutoff,
            trans_eps=cfg.transmittance_eps, interpret=True,
            schunks=cfg.dma_chunks, sat_check=cfg.sat_check,
        )
        ranks_keyed = jnp.where(valid_p, b.pair_gauss, proj.means2d.shape[0])
        out = jax_pallas._raster_forward(
            jax_pallas._gather_sorted_t(table10, ranks_keyed),
            b.tile_offsets, b.tile_counts, static,
        ).reshape(num_tiles, jax_pallas.NROW, -1)
        pal_rgbd = jnp.swapaxes(out[:, 0:4, :], 1, 2)
        return b, jnp_rgbd, jnp_t, pal_rgbd, out[:, 4, :]

    b, jnp_rgbd, jnp_t, pal_rgbd, pal_t = run(proj, colors, op)
    return proj, colors, op, b, (jnp_rgbd, jnp_t), (pal_rgbd, pal_t)


def _torch_stage(proj, colors, op, b, width, height):
    """The port's compositor on the JAX pair list."""
    cfg = TorchConfig()
    tproj = ProjectedGaussians(*(torch.from_numpy(np.array(x)) for x in proj))
    table = tile_raster.build_splat_table(
        tproj, torch.from_numpy(np.array(colors)), torch.from_numpy(np.array(op)),
        torch.from_numpy(np.array(b.order)).long(), cfg,
    )
    args = (
        table, torch.from_numpy(np.array(b.pair_gauss)),
        torch.from_numpy(np.array(b.tile_offsets)),
        torch.from_numpy(np.array(b.tile_counts)),
    )
    tiles = tile_raster.composite_pairs(*args, cfg.tiles_x(width), cfg)
    images = tile_raster.raster_forward_torch(*args, width, height, cfg)
    return cfg, args, tiles, images


def _close(got, want, what):
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL, err_msg=what
    )


@pytest.mark.parametrize("kind,seed", [
    ("random", 0), ("random", 1), ("deep", 5), ("corner", 0),
])
def test_compositor_matches_pallas_and_jnp(kind, seed):
    leaves, width, height = _scene(kind, seed)
    proj, colors, op, b, jnp_out, pal_out = _jax_stage(leaves, width, height)
    _, _, (rgbd, t_final), _ = _torch_stage(proj, colors, op, b, width, height)
    assert int(b.num_pairs) > 0
    if kind == "deep":
        assert int(np.asarray(b.tile_counts).max()) > 128  # multi-chunk segment
    if kind == "corner":
        assert int((np.asarray(b.tile_counts) == 0).sum()) >= 20  # empty tiles
        assert float(t_final[0].min()) == 1.0  # an empty tile stays transparent
    for name, (want_rgbd, want_t) in (("pallas", pal_out), ("jnp", jnp_out)):
        _close(rgbd[..., :3], want_rgbd[..., :3], f"{name} rgb")
        _close(rgbd[..., 3], want_rgbd[..., 3], f"{name} depth")
        _close(t_final, want_t, f"{name} T_final")


@pytest.mark.parametrize("sat_check", [True, False])
def test_saturated_scene_sat_check(sat_check):
    """The plain version walks whole segments (exact semantics); the Pallas
    kernel with its early-saturation skip deviates by at most trans_eps."""
    leaves, width, height = _scene("saturated", 1)
    proj, colors, op, b, _, (pal_rgbd, pal_t) = _jax_stage(
        leaves, width, height, sat_check=sat_check
    )
    _, _, (rgbd, t_final), _ = _torch_stage(proj, colors, op, b, width, height)
    _close(rgbd, pal_rgbd, "rgbd")
    _close(t_final, pal_t, "T_final")
    assert float(t_final.min()) < 1e-3  # the scene does saturate


def test_tile_batches_and_image_assembly():
    """Batched compositing equals one batch; images equal assembled tiles."""
    leaves, width, height = _scene("random", 2)
    proj, colors, op, b, _, _ = _jax_stage(leaves, width, height)
    cfg, args, (rgbd_tiles, t_tiles), (rgbd_img, t_img) = _torch_stage(
        proj, colors, op, b, width, height
    )
    tx_n, ty_n = cfg.tiles_x(width), cfg.tiles_y(height)
    want = tile_raster.tiles_to_image(
        rgbd_tiles, tx_n, ty_n, width, height, cfg.tile_width, cfg.tile_height
    )
    assert rgbd_img.shape == (height, width, 4) and t_img.shape == (height, width)
    np.testing.assert_allclose(rgbd_img.numpy(), want.numpy(), atol=1e-6)
    small = tile_raster.raster_forward_torch(*args, width, height, cfg, max_batch_pairs=7)
    np.testing.assert_allclose(small[0].numpy(), rgbd_img.numpy(), atol=2e-6)
    np.testing.assert_allclose(small[1].numpy(), t_img.numpy(), atol=2e-6)
    part = tile_raster.composite_pairs(*args, tx_n, cfg, tile_range=(2, 5))
    np.testing.assert_allclose(part[0].numpy(), rgbd_tiles[2:5].numpy(), atol=2e-6)


def test_cpu_tensors_never_reach_the_cuda_kernel(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("CUDA launch attempted for CPU tensors")

    monkeypatch.setattr(cuda_raster, "_launch_forward", boom)
    monkeypatch.setattr(cuda_raster._build, "load_library", boom)
    cuda_raster.reset_launch_counts()
    leaves, width, height = _scene("random", 0)
    model = convert.model_from_numpy(leaves, device="cpu")
    cam = convert.camera_from_numpy(
        np.eye(4, dtype=np.float32), 80.0, 80.0,
        width / 2, height / 2, width, height, device="cpu",
    )
    cam.viewmat[2, 3] = 4.0
    out = torch_render(model, cam, TorchConfig(backend="auto"))
    assert out.image.shape == (height, width, 3) and float(out.alpha.detach().max()) > 0.1
    assert cuda_raster.launch_counts["raster_fwd"] == 0
    # the wrapper itself hands CPU tensors to the plain version
    proj, colors, op, b, _, _ = _jax_stage(leaves, width, height)
    cfg, args, _, (rgbd_img, _) = _torch_stage(proj, colors, op, b, width, height)
    got = cuda_raster.raster_forward(*args, width, height, cfg)
    np.testing.assert_array_equal(got[0].numpy(), rgbd_img.numpy())
    assert cuda_raster.launch_counts["raster_fwd"] == 0


def test_backend_cuda_on_cpu_tensors_raises():
    leaves, width, height = _scene("corner", 0)
    model = convert.model_from_numpy(leaves, device="cpu")
    cam = convert.camera_from_numpy(
        np.eye(4, dtype=np.float32), 80.0, 80.0, 64.0, 48.0, width, height, device="cpu"
    )
    with pytest.raises(ValueError, match="CUDA tensors"):
        torch_render(model, cam, TorchConfig(backend="cuda"))
    with pytest.raises(ValueError, match="unknown backend"):
        torch_render(model, cam, TorchConfig(backend="pallas"))


def test_cuda_backward_is_not_routed_to_the_plain_version(monkeypatch):
    """CUDA tensors never reach the plain backward or the plain segment sum:
    each wrapper sends them to its kernel's launcher (which, with no GPU
    here, is a stub that records the call), and CPU tensors never reach a
    launcher."""
    calls = []

    def plain(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    def launcher(name):
        def launch(*a, **k):
            calls.append(name)
            return "launched"
        return launch

    class OnCuda:  # stands for a tensor that lies on the GPU
        is_cuda = True

    monkeypatch.setattr(tile_raster, "raster_backward_torch", plain)
    monkeypatch.setattr(tile_raster, "segment_sum_torch", plain)
    monkeypatch.setattr(binning, "rank_permutation_by_mask", plain)
    monkeypatch.setattr(cuda_raster, "_launch_backward", launcher("raster_bwd"))
    monkeypatch.setattr(cuda_raster, "_launch_rank_perm", launcher("rank_perm"))
    monkeypatch.setattr(cuda_raster, "_launch_segsum", launcher("segsum"))
    x = OnCuda()
    assert cuda_raster.raster_backward(x, x, x, x, x, x, x, x, 8, 8, TorchConfig()) == "launched"
    assert cuda_raster.rank_permutation_from_sort(x, x, x, TorchConfig()) == "launched"
    assert cuda_raster.segment_sum(x, x, x, 4) == "launched"
    assert calls == ["raster_bwd", "rank_perm", "segsum"]

    # and the other way round: CPU tensors take the plain versions, no launch
    monkeypatch.undo()
    calls.clear()
    monkeypatch.setattr(cuda_raster, "_launcher", launcher("build"))
    cuda_raster.reset_launch_counts()
    leaves, width, height = _scene("random", 0)
    model = convert.model_from_numpy(leaves, device="cpu")
    cam = convert.camera_from_numpy(
        np.eye(4, dtype=np.float32), 80.0, 80.0,
        width / 2, height / 2, width, height, device="cpu",
    )
    cam.viewmat[2, 3] = 4.0
    torch_render(model, cam, TorchConfig()).image.mean().backward()
    assert model.means.grad is not None and not calls
    assert cuda_raster.launch_counts == dict.fromkeys(cuda_raster.KERNELS, 0)
