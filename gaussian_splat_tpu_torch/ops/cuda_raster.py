"""The CUDA raster kernels' wrappers: build, launch, count, differentiate.

Counterpart of gaussian_splat_tpu/ops/pallas_raster.py. Four hand-written
kernels (csrc/, see each source's header for its design), each with a wrapper
here and a plain PyTorch version of the same arguments in ops/tile_raster.py
(rank_perm's in ops/binning.py):

  kernel      wrapper                     plain version          replaces (TPU)
  raster_fwd  raster_forward              raster_forward_torch   _fwd_kernel
  raster_bwd  raster_backward             raster_backward_torch  _bwd_kernel
  rank_perm   rank_permutation_from_sort  rank_permutation_by_mask
                                                                 the lax.sort in
                                                                 _gather_pairs_t_bwd
  segsum      segment_sum                 segment_sum_torch      _segsum_kernel

The two raster kernels share csrc/raster_common.cuh: the thread layout (8×4
pixel warps), the per-splat extent and the per-warp cull; their plain mirrors
(`tile_thread_pixels`, `tile_warp_rects`, `warp_pixel_rects`,
`splat_extent_torch`, `extent_misses_rect`) are in ops/tile_raster.py too.
Both render one band of a frame when given `tile_row0` (the band's first
global tile row, 0 for a whole frame): pixel centres are global, the images
hold the band's rows. segsum, bound by the
bytes of its row gather, splits its work by pairs: a warp per run of ranks
plus sorted positions, owning the ranks placed in its run (the owner rule's
plain mirror is `tile_raster.segsum_runs`). rank_perm packs the kept cells
binning decided (`BinningResult.kept`) into a bitmask of ceil(k / 32) words
an emission row, each with its place (8 MB at 1M splats, held in L2), then
adds each pair into perm at its word's place plus the popcount of the bits
before its slot (its plain version, step for step, is
`binning.rank_permutation_by_mask`).

A wrapper takes the plain version only for tensors that lie on the CPU. For
CUDA tensors it launches its kernel or raises — build failure, refused launch,
unsupported shape: nothing falls back. `launch_counts[name]` goes up by one
exactly where that kernel is launched; it also counts the SH colour's two
kernels, `sh_fwd` and `sh_bwd` (csrc/sh.cu, wrapped in ops/sh.py), the
projection's, `proj_fwd` and `proj_bwd` (csrc/projection.cu, wrapped in
ops/projection.py), and binning's four, `bin_rects`, `bin_count`,
`bin_offsets` and `bin_scatter` (csrc/binning.cu, one launch of the chain,
wrapped in ops/binning.py).

`rasterize` is the differentiable raster stage: one `torch.autograd.Function`
spanning the (fused) pair gather and the compositing, as the reference's
`raster_pairs_sorted` does. Forward = raster_fwd; backward = raster_bwd
(per-pair gradient rows) → rank_perm (the pairs' rank order, read from
binning's own sort where the reference sorts the pairs again with
`lax.sort`; equal, element for element, to the stable sort
`tile_raster.rank_permutation`) → segsum → the gradient of the rank-ordered
table. Autograd's own transpose of `table[order]` takes that back to splat
order. On CPU tensors the same Function runs the plain versions, so the CPU
tests exercise the explicit backward formulas and rank_perm's own rule.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from gaussian_splat_tpu_torch import _build
from gaussian_splat_tpu_torch.config import RenderConfig
from gaussian_splat_tpu_torch.ops import binning as binning_ops
from gaussian_splat_tpu_torch.ops import tile_raster
from gaussian_splat_tpu_torch.ops.binning import BinningResult
from gaussian_splat_tpu_torch.ops.projection import ProjectedGaussians

# every kernel whose launches are counted here: the raster stage's four, the
# SH colour's two (their wrappers are in ops/sh.py), the projection's two
# (ops/projection.py) and binning's four (ops/binning.py)
KERNELS = ("raster_fwd", "raster_bwd", "rank_perm", "segsum", "sh_fwd", "sh_bwd",
           "proj_fwd", "proj_bwd", *binning_ops.KERNELS)
MAX_THREADS_PER_BLOCK = 1024
ROW_COLS = tile_raster.TABLE_COLS  # gradient rows are laid out like table rows

# kernel launches made by this process, per kernel (see reset_launch_counts)
launch_counts: Dict[str, int] = dict.fromkeys(KERNELS, 0)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = {
    "raster_fwd": [_P] * 8 + [_I] * 7 + [_F, _F, _I, _P],
    "raster_bwd": [_P] * 11 + [_I] * 8 + [_F, _P],
    "rank_perm": [_P] * 7 + [_I] * 5 + [_P],
    "segsum": [_P] * 4 + [_I, _I, _P],
    "sh_fwd": [_P] * 3 + [_I] * 3 + [_P],
    "sh_bwd": [_P] * 5 + [_I] * 3 + [_P],
    "proj_fwd": [_P] * 19 + [_I] * 4 + [_F] * 4 + [_P],
    "proj_bwd": [_P] * 21 + [_I] * 4 + [_F] * 4 + [_P],
    "binning": [_P] * 15 + [_L] * 2 + [_I] * 9 + [_L] * 5 + [_F] * 2 + [_P],
}


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0


def _launcher(name: str, library: Optional[str] = None):
    """The C launch function `<name>_launch` of csrc/<library>.cu (default:
    <name>.cu), its library built first if need be."""
    fn = getattr(_build.load_library(library or name), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _on(dev: torch.device):
    """Makes `dev` the current CUDA device for a launch, unless it already is
    (the kernels launch on the current device; entering torch.cuda.device
    costs every launch microseconds of the host's time)."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _stream(dev: torch.device) -> int:
    """dev's current stream as a raw cudaStream_t: what
    `torch.cuda.current_stream(dev).cuda_stream` gives, without building a
    Stream object on every launch."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape, like=None,
           align: int = 16) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if like is not None and x.get_device() != like.get_device():
        raise ValueError(f"{name} is on {x.device}, expected {like.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if x.shape != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if x.data_ptr() % align:
        raise ValueError(f"{name}: needs {align}-byte alignment")


def _check_raster_inputs(kernel, table, pair_gauss, tile_offsets, tile_counts,
                         width, height, config, walked, counters) -> int:
    """Shared checks of the two raster kernels; returns the tile count."""
    tw, th = config.tile_width, config.tile_height
    if tw * th > MAX_THREADS_PER_BLOCK:
        raise ValueError(
            f"{kernel} runs one thread per tile pixel: {tw}x{th} tiles exceed "
            f"{MAX_THREADS_PER_BLOCK} threads per block"
        )
    num_tiles = config.num_tiles(width, height)
    _check("table", table, torch.float32, (table.shape[0], ROW_COLS))
    _check("pair_gauss", pair_gauss, torch.int32, (pair_gauss.shape[0],), table)
    _check("tile_offsets", tile_offsets, torch.int32, (num_tiles,), table)
    _check("tile_counts", tile_counts, torch.int32, (num_tiles,), table)
    if walked is not None:
        _check("walked", walked, torch.int32, (num_tiles,), table)
    if counters is not None:
        _check("counters", counters, torch.int32, (num_tiles, 2), table)
    return num_tiles


def _ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    return x.data_ptr() if x is not None else None


def _launch_forward(
    table, pair_gauss, tile_offsets, tile_counts, width, height, config, walked,
    counters, tile_row0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    num_tiles = _check_raster_inputs(
        "raster_fwd", table, pair_gauss, tile_offsets, tile_counts, width, height,
        config, walked, counters,
    )
    launch = _launcher("raster_fwd")
    dev = table.device
    with _on(dev):
        rgbd = torch.empty((height, width, 4), dtype=torch.float32, device=dev)
        t_final = torch.empty((height, width), dtype=torch.float32, device=dev)
        err = launch(
            table.data_ptr(), pair_gauss.data_ptr(), tile_offsets.data_ptr(),
            tile_counts.data_ptr(), rgbd.data_ptr(), t_final.data_ptr(),
            _ptr(walked), _ptr(counters),
            num_tiles, config.tiles_x(width), config.tile_width, config.tile_height,
            width, height, tile_row0, config.alpha_clamp, config.transmittance_eps,
            int(config.sat_check), _stream(dev),
        )
    if err != 0:
        raise RuntimeError(f"raster_fwd launch failed: CUDA error {err}")
    launch_counts["raster_fwd"] += 1
    return rgbd, t_final


def _launch_backward(
    table, pair_gauss, tile_offsets, tile_counts, rgbd, t_final, d_rgbd,
    d_t_final, width, height, config, walked, counters, tile_row0,
) -> torch.Tensor:
    num_tiles = _check_raster_inputs(
        "raster_bwd", table, pair_gauss, tile_offsets, tile_counts, width, height,
        config, walked, counters,
    )
    for name, x in (("rgbd", rgbd), ("d_rgbd", d_rgbd)):
        _check(name, x, torch.float32, (height, width, 4), table)
    for name, x in (("t_final", t_final), ("d_t_final", d_t_final)):
        _check(name, x, torch.float32, (height, width), table)
    launch = _launcher("raster_bwd")
    dev = table.device
    num_rows = pair_gauss.shape[0]
    with _on(dev):
        rows = torch.empty((num_rows, ROW_COLS), dtype=torch.float32, device=dev)
        err = launch(
            table.data_ptr(), pair_gauss.data_ptr(), tile_offsets.data_ptr(),
            tile_counts.data_ptr(), _ptr(walked),
            rgbd.data_ptr(), t_final.data_ptr(), d_rgbd.data_ptr(),
            d_t_final.data_ptr(), rows.data_ptr(), _ptr(counters),
            num_rows, num_tiles, config.tiles_x(width), config.tile_width,
            config.tile_height, width, height, tile_row0, config.alpha_clamp,
            _stream(dev),
        )
    if err != 0:
        raise RuntimeError(f"raster_bwd launch failed: CUDA error {err}")
    launch_counts["raster_bwd"] += 1
    return rows


def _launch_rank_perm(pair_src, rank_starts, config, kept) -> torch.Tensor:
    num_rows, n = pair_src.shape[0], rank_starts.shape[0] - 1
    slots = binning_ops.emission_rows(n, config)
    _check("pair_src", pair_src, torch.int32, (num_rows,))
    _check("rank_starts", rank_starts, torch.int32, (n + 1,), pair_src)
    _check("kept.small", kept.small, torch.bool, (n, slots.k_small), pair_src)
    _check("kept.big", kept.big, torch.bool, (slots.big, slots.k_big), pair_src)
    _check("kept.big_ranks", kept.big_ranks, torch.int32, (slots.big,), pair_src)
    launch = _launcher("rank_perm")
    dev = pair_src.device
    # one allocation for the kernel's records (an int2 a bitmask word,
    # ceil(k / 32) words a row) and the permutation after them: each
    # torch.empty costs the launch microseconds of the host's time
    scratch = -(-2 * slots.mask_words // 4) * 4
    with _on(dev):
        buf = torch.empty((max(scratch + num_rows, 1),), dtype=torch.int32, device=dev)
        perm = buf[scratch : scratch + num_rows]
        err = launch(
            pair_src.data_ptr(), kept.small.data_ptr(), kept.big.data_ptr(),
            kept.big_ranks.data_ptr(), rank_starts.data_ptr(), buf.data_ptr(),
            perm.data_ptr(), n, num_rows, slots.k_small, slots.k_big, slots.big,
            _stream(dev),
        )
    if err != 0:
        raise RuntimeError(f"rank_perm launch failed: CUDA error {err}")
    launch_counts["rank_perm"] += 1
    return perm


def _launch_segsum(rows, perm, rank_starts, n) -> torch.Tensor:
    num_rows = rows.shape[0]
    _check("rows", rows, torch.float32, (num_rows, ROW_COLS))
    _check("perm", perm, torch.int32, (num_rows,), rows)
    _check("rank_starts", rank_starts, torch.int32, (n + 1,), rows)
    launch = _launcher("segsum")
    dev = rows.device
    with _on(dev):
        out = torch.empty((n, ROW_COLS), dtype=torch.float32, device=dev)
        err = launch(
            rows.data_ptr(), perm.data_ptr(), rank_starts.data_ptr(),
            out.data_ptr(), n, num_rows, _stream(dev),
        )
    if err != 0:
        raise RuntimeError(f"segsum launch failed: CUDA error {err}")
    launch_counts["segsum"] += 1
    return out


def raster_forward(
    table: torch.Tensor,  # (N, 12) f32 rank-ordered per-splat table
    pair_gauss: torch.Tensor,  # (B,) i32 depth rank per pair
    tile_offsets: torch.Tensor,  # (T,) i32
    tile_counts: torch.Tensor,  # (T,) i32
    width: int,
    height: int,
    config: RenderConfig,
    # optional (T,) i32 out: pairs each tile walked before its early exit
    walked: Optional[torch.Tensor] = None,
    # optional (T, 2) i32, zeroed by the caller: the kernel adds, per tile, its
    # kept steps inside the image and the (warp, pair)s its cull let through
    counters: Optional[torch.Tensor] = None,
    tile_row0: int = 0,  # a band's first global tile row; height = its rows
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward raster kernel: (rgbd (H,W,4), T_final (H,W)), no background
    applied, no autograd graph (`rasterize` is the differentiable stage).

    CUDA tensors go to the kernel (or raise); CPU tensors to the plain
    version, which walks whole segments and leaves `walked` and `counters`
    alone."""
    if not table.is_cuda:
        with torch.no_grad():
            return tile_raster.raster_forward_torch(
                table, pair_gauss, tile_offsets, tile_counts, width, height, config,
                tile_row0,
            )
    return _launch_forward(
        table.detach(), pair_gauss, tile_offsets, tile_counts, width, height,
        config, walked, counters, tile_row0,
    )


def raster_backward(
    table: torch.Tensor,
    pair_gauss: torch.Tensor,
    tile_offsets: torch.Tensor,
    tile_counts: torch.Tensor,
    rgbd: torch.Tensor,  # (H, W, 4) forward result
    t_final: torch.Tensor,  # (H, W) forward result
    d_rgbd: torch.Tensor,  # (H, W, 4) cotangent
    d_t_final: torch.Tensor,  # (H, W) cotangent
    width: int,
    height: int,
    config: RenderConfig,
    walked: Optional[torch.Tensor] = None,  # (T,) i32 from the forward
    counters: Optional[torch.Tensor] = None,  # (T, 2) i32, as in raster_forward
    tile_row0: int = 0,  # as in raster_forward
) -> torch.Tensor:
    """The backward raster kernel: (B, 12) f32 gradient rows, one per pair in
    the pair list's order, laid out like the table's rows (columns 10 and 11
    zero). Unwalked and padding pairs get zero rows.

    CUDA tensors go to the kernel (or raise); CPU tensors to the plain version."""
    if not table.is_cuda:
        rows10 = tile_raster.raster_backward_torch(
            table, pair_gauss, tile_offsets, tile_counts, rgbd, t_final,
            d_rgbd, d_t_final, width, height, config, walked=walked,
            tile_row0=tile_row0,
        )
        return torch.nn.functional.pad(rows10, (0, ROW_COLS - rows10.shape[1]))
    return _launch_backward(
        table, pair_gauss, tile_offsets, tile_counts, rgbd, t_final,
        d_rgbd, d_t_final, width, height, config, walked, counters, tile_row0,
    )


def rank_permutation_from_sort(
    pair_src: torch.Tensor,  # (B,) i32 BinningResult.pair_src
    rank_starts: torch.Tensor,  # (M+1,) i32, over the M active ranks
    kept: binning_ops.KeptCells,  # BinningResult.kept
    config: RenderConfig,
) -> torch.Tensor:
    """The rank-order kernel: (B,) i32, the stable sort of the pair list by
    depth rank (`tile_raster.rank_permutation`), read from binning's own sort
    and the kept cells it decided, with no second sort.

    CUDA tensors go to the kernel (or raise); CPU tensors to its plain
    version, `binning.rank_permutation_by_mask`."""
    if not pair_src.is_cuda:
        return binning_ops.rank_permutation_by_mask(pair_src, rank_starts, kept, config)
    return _launch_rank_perm(pair_src, rank_starts, config, kept)


def segment_sum(
    rows: torch.Tensor,  # (B, 12) f32 per-pair rows
    perm: torch.Tensor,  # (B,) i32 `rank_permutation_from_sort`
    rank_starts: torch.Tensor,  # (N+1,) i32
    n: int,
) -> torch.Tensor:
    """The segment-sum kernel: out[r] = Σ rows[perm[rank_starts[r] :
    rank_starts[r+1]]], (N, 12) f32, summed in a fixed order.

    CUDA tensors go to the kernel (or raise); CPU tensors to the plain version."""
    if not rows.is_cuda:
        return tile_raster.segment_sum_torch(rows, perm, rank_starts, n)
    return _launch_segsum(rows, perm, rank_starts, n)


class _Raster(torch.autograd.Function):
    """gather + raster as one differentiable stage; see the module docstring."""

    @staticmethod
    def forward(ctx, table, pair_gauss, pair_src, tile_offsets, tile_counts,
                rank_starts, kept, width, height, config, tile_row0):
        # the early exit is the kernel's; the plain forward walks everything
        walked = torch.empty_like(tile_counts) if table.is_cuda else None
        rgbd, t_final = raster_forward(
            table, pair_gauss, tile_offsets, tile_counts, width, height,
            config, walked=walked, tile_row0=tile_row0,
        )
        ctx.save_for_backward(
            table, pair_gauss, pair_src, tile_offsets, tile_counts, rank_starts,
            rgbd, t_final, walked,
        )
        ctx.frame = (width, height, config, tile_row0)
        ctx.kept = kept  # binning's masks, not inputs of this Function
        return rgbd, t_final

    @staticmethod
    @once_differentiable
    def backward(ctx, d_rgbd, d_t_final):
        (table, pair_gauss, pair_src, tile_offsets, tile_counts, rank_starts,
         rgbd, t_final, walked) = ctx.saved_tensors
        width, height, config, tile_row0 = ctx.frame
        rows = raster_backward(
            table, pair_gauss, tile_offsets, tile_counts, rgbd, t_final,
            d_rgbd.contiguous(), d_t_final.contiguous(), width, height, config,
            walked=walked, tile_row0=tile_row0,
        )
        perm = rank_permutation_from_sort(pair_src, rank_starts, ctx.kept, config)
        d_table = segment_sum(rows, perm, rank_starts, table.shape[0])
        return d_table, *(None,) * 10


def rasterize(
    table: torch.Tensor,
    binning: BinningResult,
    width: int,
    height: int,
    config: RenderConfig,
    tile_row0: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The differentiable raster stage, (rgbd (H,W,4), T_final (H,W)): the
    kernels on CUDA tensors (or raises), their plain versions on CPU tensors;
    the backward is the explicit one either way. `table` holds the binning's
    `num_active` ranks; `tile_row0` places a band of `height` rows."""
    return _Raster.apply(
        table, binning.pair_gauss, binning.pair_src, binning.tile_offsets,
        binning.tile_counts, binning.rank_starts, binning.kept, width, height, config,
        tile_row0,
    )


def render_tiled_cuda(
    proj: ProjectedGaussians,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    width: int,
    height: int,
    config: RenderConfig,
    max_active: Optional[int] = None,
    tile_row0: int = 0,
    total_tiles_y: Optional[int] = None,
) -> Tuple[torch.Tensor, ...]:
    """Full tiled render through the CUDA kernels; raises on CPU tensors.
    The band arguments as in `tile_raster.render_tiled`."""
    if not proj.means2d.is_cuda:
        raise ValueError(
            f'backend "cuda" needs CUDA tensors, got {proj.means2d.device}'
        )
    return tile_raster.render_tiled(
        proj, colors, opacities, width, height, config, raster_fn=rasterize,
        max_active=max_active, tile_row0=tile_row0, total_tiles_y=total_tiles_y,
    )
