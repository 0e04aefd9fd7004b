"""The CUDA forward raster kernel's wrapper: build, launch, count.

Counterpart of the forward half of gaussian_splat_tpu/ops/pallas_raster.py
(`_fwd_kernel`, `_raster_forward`, `render_tiled_pallas`). The kernel itself
is csrc/raster_fwd.cu — see its header for the design and the rounding rules;
its plain PyTorch version is `tile_raster.raster_forward_torch`, which takes
the same arguments and returns the same images.

`raster_forward` takes the plain version only for tensors that lie on the
CPU. For CUDA tensors it launches the kernel or raises — build failure,
refused launch, unsupported shape: nothing falls back. `launch_count` goes up
by one exactly where the kernel is launched.

The backward raises NotImplementedError: the backward kernels belong to the
training slice. (On CPU tensors `render` uses the torch tile compositor, which
autograd differentiates.)
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from gaussian_splat_tpu_torch import _build
from gaussian_splat_tpu_torch.config import RenderConfig
from gaussian_splat_tpu_torch.ops import tile_raster
from gaussian_splat_tpu_torch.ops.projection import ProjectedGaussians

KERNEL = "raster_fwd"
MAX_THREADS_PER_BLOCK = 1024

launch_count = 0  # kernel launches made by this process (see reset_launch_count)


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def _library() -> ctypes.CDLL:
    lib = _build.load_library(KERNEL)
    fn = lib.raster_fwd_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, f, f, i, p]
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _launch(
    table, pair_gauss, tile_offsets, tile_counts, width, height, config, walked
) -> Tuple[torch.Tensor, torch.Tensor]:
    global launch_count
    tw, th = config.tile_width, config.tile_height
    tx_n, ty_n = config.tiles_x(width), config.tiles_y(height)
    num_tiles = tx_n * ty_n
    if tw * th > MAX_THREADS_PER_BLOCK:
        raise ValueError(
            f"raster_fwd runs one thread per tile pixel: {tw}x{th} tiles exceed "
            f"{MAX_THREADS_PER_BLOCK} threads per block"
        )
    dev = table.device
    _check("table", table, torch.float32, (table.shape[0], tile_raster.TABLE_COLS))
    _check("pair_gauss", pair_gauss, torch.int32, (pair_gauss.shape[0],))
    _check("tile_offsets", tile_offsets, torch.int32, (num_tiles,))
    _check("tile_counts", tile_counts, torch.int32, (num_tiles,))
    for name, x in (("pair_gauss", pair_gauss), ("tile_offsets", tile_offsets),
                    ("tile_counts", tile_counts)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, table on {dev}")
    if table.data_ptr() % 16:
        raise ValueError("table: rows are read as float4, need 16-byte alignment")
    if walked is not None:
        _check("walked", walked, torch.int32, (num_tiles,))

    lib = _library()
    with torch.cuda.device(dev):
        rgbd = torch.empty((height, width, 4), dtype=torch.float32, device=dev)
        t_final = torch.empty((height, width), dtype=torch.float32, device=dev)
        err = lib.raster_fwd_launch(
            table.data_ptr(), pair_gauss.data_ptr(), tile_offsets.data_ptr(),
            tile_counts.data_ptr(), rgbd.data_ptr(), t_final.data_ptr(),
            walked.data_ptr() if walked is not None else None,
            num_tiles, tx_n, tw, th, width, height,
            config.alpha_clamp, config.transmittance_eps, int(config.sat_check),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"raster_fwd launch failed: CUDA error {err}")
    launch_count += 1
    return rgbd, t_final


class _RasterForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, pair_gauss, tile_offsets, tile_counts, width,
                height, config, walked):
        return _launch(
            table, pair_gauss, tile_offsets, tile_counts, width, height,
            config, walked,
        )

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("raster backward kernel: training slice")


def raster_forward(
    table: torch.Tensor,  # (N, 12) f32 rank-ordered per-splat table
    pair_gauss: torch.Tensor,  # (B,) i32 depth rank per pair
    tile_offsets: torch.Tensor,  # (T,) i32
    tile_counts: torch.Tensor,  # (T,) i32
    width: int,
    height: int,
    config: RenderConfig,
    # optional (T,) i32 out: pairs each tile walked before its early exit
    # (chip_smoke.py counts the kernel's bound from it)
    walked: torch.Tensor = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The raster stage: (rgbd (H,W,4), T_final (H,W)), no background applied.

    CUDA tensors go to the kernel (or raise); CPU tensors to the plain version."""
    if not table.is_cuda:
        return tile_raster.raster_forward_torch(
            table, pair_gauss, tile_offsets, tile_counts, width, height, config
        )
    return _RasterForward.apply(
        table, pair_gauss, tile_offsets, tile_counts, width, height, config, walked
    )


def render_tiled_cuda(
    proj: ProjectedGaussians,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    width: int,
    height: int,
    config: RenderConfig,
) -> Tuple[torch.Tensor, ...]:
    """Full tiled render through the CUDA kernel; raises on CPU tensors."""
    if not proj.means2d.is_cuda:
        raise ValueError(
            f'backend "cuda" needs CUDA tensors, got {proj.means2d.device}'
        )
    return tile_raster.render_tiled(
        proj, colors, opacities, width, height, config, raster_fn=raster_forward
    )
