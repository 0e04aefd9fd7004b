"""Top-level render pipeline: activations → SH → projection → rasterization.

Counterpart of gaussian_splat_tpu/ops/render.py. Backend selection:

  * "reference":  the O(N·H·W) oracle (tests/small scenes; exact semantics)
  * "torch_tile": tile binning + segmented-cumsum compositing in plain torch
                  (the CPU backend, differentiated by autograd, and the plain
                  version the CUDA kernels are held against)
  * "cuda":       tile binning + the hand-written CUDA raster kernels, forward
                  and backward (ops/cuda_raster.py)
  * "auto":       "cuda" for CUDA tensors, "torch_tile" for CPU tensors

The choice follows where the model's tensors lie, never whether a build or a
launch succeeded: on CUDA tensors "auto" launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from gaussian_splat_tpu_torch._device import DeviceLike, require_device
from gaussian_splat_tpu_torch.camera import Camera
from gaussian_splat_tpu_torch.config import BACKENDS, RenderConfig
from gaussian_splat_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_tpu_torch.ops import reference as reference_ops
from gaussian_splat_tpu_torch.ops import sh as sh_ops
from gaussian_splat_tpu_torch.ops.binning import (
    MAX_K_BIG, BinningStats, quantize_extent_up, tile_rects,
)
from gaussian_splat_tpu_torch.ops.projection import (
    ProjectedGaussians, project_with_directions,
)


class RenderOutput(NamedTuple):
    image: torch.Tensor  # (H, W, 3) composited color (background applied)
    alpha: torch.Tensor  # (H, W) 1 − T_final
    depth: Optional[torch.Tensor] = None  # (H, W) α-weighted expected depth
    projected: Optional[ProjectedGaussians] = None  # per-gaussian debug info
    stats: Optional[BinningStats] = None  # binning sentinels of the tiled
    #   backends (None for "reference"); 0-d tensors, unread unless asked for


def _project_and_shade(model: GaussianModel, camera: Camera, config: RenderConfig):
    if camera.device != model.device:
        raise ValueError(
            f"camera is on {camera.device}, model on {model.device}: "
            f"move one with .to(device)"
        )
    proj, dirs = project_with_directions(
        model.means,
        model.quats,
        model.scales,
        camera,
        near_plane=config.near_plane,
        cov2d_dilation=config.cov2d_dilation,
        sigma_extent=config.sigma_extent,
        # opacity-aware extents are an upper bound for the antialiased mode
        # too: compensation ≤ 1 only lowers effective opacity further
        opacities=model.opacities if config.opacity_aware_extent else None,
        alpha_skip=config.alpha_skip if config.opacity_aware_extent else None,
    )
    degree = min(config.sh_degree, model.sh_degree)
    colors = sh_ops.eval_sh(degree, model.sh, dirs)
    return proj, colors


def _effective_opacities(model: GaussianModel, proj, config: RenderConfig):
    op = model.opacities
    if config.antialiased:
        op = op * proj.compensation
    return op


def render(
    model: GaussianModel,
    camera: Camera,
    config: RenderConfig = RenderConfig(),
    screen_offset: Optional[torch.Tensor] = None,
) -> RenderOutput:
    """Render a scene on the device the model lies on.

    The result is differentiable w.r.t. every GaussianModel parameter and
    w.r.t. `screen_offset`, on either device: on CUDA tensors the raster
    stage's gradient is the backward kernels', on CPU tensors autograd's
    through the plain compositor. `screen_offset` is an optional (N, 2)
    tensor added to the projected 2D means (the densification criterion
    differentiates w.r.t. it)."""
    backend = config.backend
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "auto":
        backend = "cuda" if model.device.type == "cuda" else "torch_tile"

    proj, colors = _project_and_shade(model, camera, config)
    if screen_offset is not None:
        proj = proj._replace(means2d=proj.means2d + screen_offset)
    opacities = _effective_opacities(model, proj, config)

    stats = None
    if backend == "reference":
        image, t_final, depth = reference_ops.render_reference(
            proj.means2d, proj.conics, colors, opacities, proj.depths,
            proj.valid, camera.width, camera.height, config,
        )
    elif backend == "torch_tile":
        from gaussian_splat_tpu_torch.ops import tile_raster

        image, t_final, depth, stats = tile_raster.render_tiled(
            proj, colors, opacities, camera.width, camera.height, config
        )
    else:  # "cuda"
        from gaussian_splat_tpu_torch.ops import cuda_raster

        image, t_final, depth, stats = cuda_raster.render_tiled_cuda(
            proj, colors, opacities, camera.width, camera.height, config
        )

    return RenderOutput(
        image=image, alpha=1.0 - t_final, depth=depth, projected=proj, stats=stats
    )


@torch.no_grad()
def calibrate_render_config(
    model: GaussianModel,
    cameras,
    config: RenderConfig = RenderConfig(),
    pair_headroom: float = 1.15,
    big_headroom: float = 1.2,
    mesh_ndev: Optional[int] = None,
    margin_headroom: float = 2.0,
    mesh=None,
) -> RenderConfig:
    """Measure scene-dependent capacities and return a tightened config.

    Every pair-proportional stage scales with `pair_budget`, and the big-tier
    expansion block with the tier capacity — but both defaults are sized for a
    worst case the scene may be nowhere near. This helper renders nothing: one
    projection + rect pass per calibration camera measures

      * the total K-capped rect-cell count (an upper bound on num_pairs — the
        σ-bound cell test only removes pairs), setting `pairs_per_gaussian`
        with `pair_headroom`, and
      * the big-tier-eligible count (K-capped area > small cap), setting
        `big_tier_capacity` with `big_headroom` (so tier_overflow == 0).

    It also raises the K cap (`max_tiles_per_gaussian`) to the largest
    frame's tile count, as far as the binning kernels take (`MAX_K_BIG`):
    no rect spans more tiles than its frame, so no rect is shrunk
    (`clamped_rects` stays 0) however far training grows a splat. The cap
    costs the big tier's rows K bytes each; the tier gets at least the rows
    that the small tier's bytes would hold (N·k_small/K), room for splats
    that training grows past the small cap.

    With both sentinels at 0 the calibrated config renders BIT-IDENTICAL
    output to the given config wherever that config shrinks no rect — the
    budget, capacity and cap only affect truncation and padding.

    With `mesh_ndev`, a third measurement sizes `shard_capacity_margin`: the
    largest per-band splat incidence (the band test of the sharded path)
    minus the N/D resident share, scaled by `margin_headroom` — so the
    sharded compaction cap stays as tight as the scene allows without drops.

    With `mesh` (a `parallel.mesh.make_mesh` mesh), call it on every rank
    with that rank's block of the model (`shard_model`): each rank counts
    its own rows, the counts are summed over the ranks camera by camera,
    and every rank returns the config that the whole model gives with
    `mesh_ndev` = the mesh's size.

    `cameras` is one Camera or an iterable; the max over cameras is used."""
    cameras = [cameras] if isinstance(cameras, Camera) else list(cameras)
    frame_tiles = max(config.num_tiles(cam.width, cam.height) for cam in cameras)
    k_cap = max(config.max_tiles_per_gaussian, min(frame_tiles, MAX_K_BIG))
    config = dataclasses.replace(config, max_tiles_per_gaussian=k_cap)
    n = model.num_gaussians
    if mesh is not None:
        if mesh_ndev not in (None, mesh.size()):
            raise ValueError(f"mesh_ndev={mesh_ndev} on a mesh of {mesh.size()} ranks")
        mesh_ndev = mesh.size()
        n *= mesh_ndev
    bands = mesh_ndev if mesh_ndev is not None and mesh_ndev > 1 else 0
    # per camera: rect cells, big-tier-eligible rows, each band's incidence
    counts = []
    for cam in cameras:
        proj, _ = _project_and_shade(model, cam, config)
        _tx0, _ty0, w, h, _cl = tile_rects(
            proj.means2d, proj.radii, proj.valid, cam.width, cam.height,
            config, extents=proj.extents,
        )
        area = (w * h).to(torch.int64)
        row = [area.sum(), (area > config.small_tiles_per_gaussian).sum()]
        if bands:
            band_h = -(-config.tiles_y(cam.height) // bands) * config.tile_height
            my = proj.means2d[:, 1]
            ry = quantize_extent_up(proj.extents[:, 1])
            for d in range(bands):
                lo, hi = float(d * band_h), float((d + 1) * band_h)
                row.append((proj.valid & (my + ry > lo) & (my - ry < hi)).sum())
        counts.append(torch.stack(row))
    counts = torch.stack(counts)
    if mesh is not None:
        dist.all_reduce(counts, group=mesh.get_group())
    top = [int(v) for v in counts.max(dim=0).values.cpu()]
    max_sum_area, max_eligible, max_incidence = top[0], top[1], max(top[2:], default=0)

    ppg = max(max_sum_area * pair_headroom / max(n, 1), 0.5)
    floor = n * config.small_tiles_per_gaussian // config.max_tiles_per_gaussian
    big_cap = max(-(-int(max_eligible * big_headroom) // 1024) * 1024, floor, 64)
    updates = dict(pairs_per_gaussian=round(ppg, 3), big_tier_capacity=big_cap)
    if bands:
        tail = max(max_incidence - -(-n // mesh_ndev), 0)
        # margin 1.0 already makes the cap N (no compaction beyond that):
        # tiny scenes with band-spanning splats can measure a tail above
        # (1 - 1/D)·N
        updates["shard_capacity_margin"] = round(
            min(tail * margin_headroom / max(n, 1), 1.0), 4
        )
    return dataclasses.replace(config, **updates)


@torch.no_grad()
def measure_pair_costs(
    model: GaussianModel,
    camera: Camera,
    config: RenderConfig = RenderConfig(),
    device: DeviceLike = None,
) -> np.ndarray:
    """Per-splat K-capped tile-rect areas at `camera` — the (N,) pair-cost
    vector behind `GaussianModel.lod_pair_budget`, on the host.

    The projection + rect pass of `calibrate_render_config` (no
    rasterization), per splat: cost[i] is the number of tile cells splat i's
    K-capped rect covers, an upper bound on the pairs it contributes (the
    σ-bound cell test only removes pairs), and 0 for splats culled at this
    camera. The model must lie on `device` (None: the GPU)."""
    require_device(model.device, device)
    proj, _ = _project_and_shade(model, camera, config)
    _tx0, _ty0, w, h, _cl = tile_rects(
        proj.means2d, proj.radii, proj.valid, camera.width, camera.height,
        config, extents=proj.extents,
    )
    return (w * h).cpu().numpy()


def measure_splat_contributions(
    model: GaussianModel,
    camera: Camera,
    config: RenderConfig = RenderConfig(),
    device: DeviceLike = None,
) -> np.ndarray:
    """Per-splat measured visual contribution at `camera`: |∂Σimage/∂logit_i|,
    (N,) on the host, from one differentiable render — the value vector for
    `GaussianModel.lod_pair_budget`.

    The raster stage is always `cuda_raster.rasterize` with its explicit
    backward, whatever `config.backend` says: on CUDA tensors one launch each
    of raster_fwd, raster_bwd and segsum, on CPU tensors their plain
    versions. The gradient is taken by `torch.autograd.grad` with respect to
    a detached copy of the logits, so the model gets no `.grad` and keeps no
    graph. As in the JAX package the image is summed BEFORE the gradient is
    taken, so signed effects of a splat on different pixels cancel (a known
    defect of the reference, ported as it is). The model must lie on
    `device` (None: the GPU)."""
    from gaussian_splat_tpu_torch.ops import cuda_raster, tile_raster

    require_device(model.device, device)
    logits = model.opacity_logits.detach().requires_grad_()
    view = model.replace(
        **{name: getattr(model, name).detach() for name in model.LEAVES},
    ).replace(opacity_logits=logits)
    with torch.enable_grad():
        proj, colors = _project_and_shade(view, camera, config)
        opacities = _effective_opacities(view, proj, config)
        image, _t, _d, _s = tile_raster.render_tiled(
            proj, colors, opacities, camera.width, camera.height, config,
            raster_fn=cuda_raster.rasterize,
        )
        (grad,) = torch.autograd.grad(image.sum(), logits)
    return grad.abs().cpu().numpy()
