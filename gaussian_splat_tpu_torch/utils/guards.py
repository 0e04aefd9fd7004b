"""Numerics guards: stage-checked rendering + NaN sweeps.

Counterpart of gaussian_splat_tpu/utils/guards.py, which runs the jnp tile
pipeline under `jax.experimental.checkify`. torch has no checkify, so
`checked_render` runs the plain tile pipeline ("torch_tile") one stage at a
time and raises `FloatingPointError` at the first stage whose output holds a
NaN or an Inf, naming the stage (projection, colours, binning, composite);
`checked_grads` differentiates under autograd's anomaly mode (which names
the backward function that made a NaN) and then checks every gradient. Use
them when a training run misbehaves; the CUDA kernels share the plain
pipeline's semantics, so numeric pathologies reproduce there.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import torch

from gaussian_splat_tpu_torch._device import DeviceLike, require_device


def _require_finite(stage: str, **tensors: torch.Tensor) -> None:
    bad = [name for name, x in tensors.items() if not bool(torch.isfinite(x).all())]
    if bad:
        raise FloatingPointError(f"non-finite values after {stage}: {', '.join(bad)}")


def _tile_config(config):
    from gaussian_splat_tpu_torch.config import RenderConfig

    return dataclasses.replace(config or RenderConfig(), backend="torch_tile")


@torch.no_grad()
def checked_render(model, camera, config=None, device: DeviceLike = None) -> torch.Tensor:
    """Render on the torch_tile path, checking each stage's outputs for
    NaN/Inf; raises FloatingPointError naming the first bad stage. Returns
    the (H, W, 3) image. The model must lie on `device` (None: the GPU)."""
    from gaussian_splat_tpu_torch.ops import tile_raster
    from gaussian_splat_tpu_torch.ops.render import _effective_opacities, _project_and_shade

    require_device(model.device, device)
    cfg = _tile_config(config)
    proj, colors = _project_and_shade(model, camera, cfg)
    _require_finite(
        "projection", means2d=proj.means2d, conics=proj.conics, depths=proj.depths,
        cov2d=proj.cov2d, extents=proj.extents,
    )
    opacities = _effective_opacities(model, proj, cfg)
    _require_finite("colours", colors=colors, opacities=opacities)

    def checked_raster(table, binning, width, height, config, tile_row0):
        _require_finite("binning", table=table)  # the binned, depth-ordered rows
        return tile_raster.raster_forward_torch(
            table, binning.pair_gauss, binning.tile_offsets, binning.tile_counts,
            width, height, config, tile_row0,
        )

    image, t_final, depth, _stats = tile_raster.render_tiled(
        proj, colors, opacities, camera.width, camera.height, cfg,
        raster_fn=checked_raster,
    )
    _require_finite("composite", image=image, t_final=t_final, depth=depth)
    return image


def checked_grads(model, camera, config=None, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Gradient of a mean-square-image loss on the torch_tile path under
    autograd's anomaly mode, then a finiteness check of every gradient;
    raises on the first NaN/Inf. Returns {leaf name: gradient}. The model
    gets no `.grad`. It must lie on `device` (None: the GPU)."""
    from gaussian_splat_tpu_torch.ops.render import render

    require_device(model.device, device)
    cfg = _tile_config(config)
    leaves = {
        name: getattr(model, name).detach().requires_grad_() for name in model.LEAVES
    }
    with torch.enable_grad(), torch.autograd.detect_anomaly():
        loss = torch.mean(render(model.replace(**leaves), camera, cfg).image ** 2)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    out = {
        name: torch.zeros_like(x) if g is None else g
        for (name, x), g in zip(leaves.items(), grads)
    }
    bad = find_nonfinite(out)
    if bad:
        raise FloatingPointError(f"non-finite gradients: {', '.join(bad)}")
    return out


def find_nonfinite(tree, prefix: str = "") -> Tuple[str, ...]:
    """Names of the tensors holding NaN/Inf (empty tuple = all finite), in a
    mapping of tensors (`prefix['key']`), a model or view (`prefix.leaf`),
    or one tensor (`prefix`)."""
    if isinstance(tree, torch.Tensor):
        items = [(prefix, tree)]
    elif isinstance(tree, Mapping):
        items = [(f"{prefix}[{k!r}]", v) for k, v in tree.items()]
    else:
        items = [(f"{prefix}.{k}", getattr(tree, k)) for k in tree.LEAVES]
    return tuple(
        name for name, x in items
        if x.is_floating_point() and not bool(torch.isfinite(x).all())
    )
