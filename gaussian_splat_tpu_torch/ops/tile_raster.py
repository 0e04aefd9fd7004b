"""Tile rasterizer in plain torch: segmented log-space compositing over the pair list.

Counterpart of gaussian_splat_tpu/ops/tile_raster.py, and the PLAIN VERSIONS of
the raster and segment-sum CUDA kernels (ops/cuda_raster.py; rank_perm's is in
ops/binning.py). `raster_forward_torch` takes the forward kernel's arguments —
the rank-ordered per-splat table, the pair list and the per-tile segments —
and returns the same images; it is the port's CPU
backend, differentiable end-to-end by autograd, and on the GPU the yardstick
the kernel is held against. `raster_backward_torch` (per-pair gradient rows by
the explicit formulas, not by autograd) and `segment_sum_torch` (rows summed
per depth rank) are the plain versions of the two backward kernels;
`segsum_runs` mirrors the segsum kernel's owner rule.

Per-tile transmittance is a segmented exclusive prefix product over the pair
list, computed as exp(segmented-cumsum(log1p(−α))) as in the reference (with
the running sum in float64, see `composite_pairs`). The CUDA kernel multiplies
T sequentially instead; the two differ by rounding only.

`composite_pairs` works on a RANGE of tiles, so a large frame can be composited
in batches: its temporaries are (pairs in the range) × (pixels per tile).

Bands (the sharded path): `tile_row0` is the band's first tile row in the
whole frame. Pixel centres are GLOBAL — py = (tile row + tile_row0)·th +
row + 0.5, so every α is the single-card one — while the images hold the
band's rows only (the rule of the reference's jnp_tile and Pallas kernels).
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from gaussian_splat_tpu_torch.config import RenderConfig
from gaussian_splat_tpu_torch.ops.binning import BinningResult, BinningStats, bin_gaussians
from gaussian_splat_tpu_torch.ops.falloff import (
    alpha_from_sigma, sigma_bound, sigma_quadform,
)
from gaussian_splat_tpu_torch.ops.projection import ProjectedGaussians

# Columns of the per-splat table (rows in depth-rank order). The first ten are
# the reference's pair features; column 10 is the per-splat σ bound, computed
# once here so that no logarithm sits in a kernel's keep decision; column 11
# pads the row to three 16-byte loads.
TABLE_COLS = 12
COL_MX, COL_MY, COL_A, COL_B, COL_C = 0, 1, 2, 3, 4
COL_R, COL_DEPTH, COL_OP, COL_BOUND = 5, 8, 9, 10


def build_splat_table(
    proj: ProjectedGaussians,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    order: torch.Tensor,
    config: RenderConfig,
) -> torch.Tensor:
    """(N, 12) float32 table [mx,my,A,B,C,r,g,b,depth,op,bound,0] gathered
    into depth-rank order — the ONE per-splat gather of a frame. Pair-sized
    feature arrays are never built: raster backends gather rows by
    `pair_gauss` themselves."""
    bound = sigma_bound(
        opacities.detach(), proj.valid, config.sigma_cutoff, config.alpha_skip
    )
    table = torch.cat(
        [
            proj.means2d,
            proj.conics,
            colors,
            proj.depths[:, None],
            opacities[:, None],
            bound[:, None],
            torch.zeros_like(bound)[:, None],
        ],
        dim=1,
    )
    return table[order].contiguous()


def tiles_to_image(
    tiles: torch.Tensor, tx_n: int, ty_n: int, width: int, height: int,
    tw: int, th: int,
) -> torch.Tensor:
    """(T, tw·th, C) tile-major pixels → (H, W, C) image (cropped)."""
    c = tiles.shape[-1]
    img = tiles.reshape(ty_n, tx_n, th, tw, c)
    img = img.permute(0, 2, 1, 3, 4).reshape(ty_n * th, tx_n * tw, c)
    return img[:height, :width]


def pair_pixel_sigma(
    table: torch.Tensor,
    pair_gauss: torch.Tensor,
    tile_offsets: torch.Tensor,
    tile_counts: torch.Tensor,
    num_tiles_x: int,
    config: RenderConfig,
    tile_range: Tuple[int, int],
    tile_row0: int = 0,
):
    """The (pixel, pair) grid of the tiles [t0, t1): returns
    (rows (b, 12), local_tile (b,), start, px (b, npix), py (b, npix),
    sigma (b, npix)) for the b pairs of the range, which are the slice
    [start, start+b) of the tile-sorted pair list. px, py are the global
    pixel centres: a band's tile rows start at `tile_row0`."""
    tw, th = config.tile_width, config.tile_height
    npix = tw * th
    dev = table.device
    t0, t1 = tile_range

    counts = tile_counts[t0:t1].to(torch.int64)
    b = int(counts.sum())
    start = int(tile_offsets[t0]) if b > 0 else 0
    local_tile = torch.repeat_interleave(
        torch.arange(t1 - t0, device=dev), counts, output_size=b
    )  # (b,) tile index within the range
    rows = table[pair_gauss[start : start + b].to(torch.int64)]  # (b, 12)

    # pixel centers of each pair's tile: (b, npix), integer-exact in float32
    lane = torch.arange(npix, device=dev)
    tile = local_tile + t0
    px = ((tile % num_tiles_x)[:, None] * tw + (lane % tw)[None, :]).to(
        torch.float32
    ) + 0.5
    py = (
        (torch.div(tile, num_tiles_x, rounding_mode="floor") + tile_row0)[:, None] * th
        + torch.div(lane, tw, rounding_mode="floor")[None, :]
    ).to(torch.float32) + 0.5

    dx = px - rows[:, COL_MX : COL_MX + 1]
    dy = py - rows[:, COL_MY : COL_MY + 1]
    sigma = sigma_quadform(
        dx, dy,
        0.5 * rows[:, COL_A : COL_A + 1],
        rows[:, COL_B : COL_B + 1],
        0.5 * rows[:, COL_C : COL_C + 1],
    )
    return rows, local_tile, start, px, py, sigma


# Margins of the per-splat extent, as in csrc/raster_common.cuh (the reasons
# are given there): det is lowered by 2^-18·A·C, the half-extents are widened
# by a factor 1 + 2^-16 and by 2^-6 pixels.
EXTENT_DET_MARGIN = 2.0**-18
EXTENT_REL_MARGIN = 1.0 + 2.0**-16
EXTENT_ABS_MARGIN = 2.0**-6
EXTENT_MIN_AC = 1e-30


def splat_extent_torch(table_rows: torch.Tensor) -> torch.Tensor:
    """(…, 4) float32 [mx, my, hx, hy]: the conservative extent that the CUDA
    raster kernels compute for each staged pair and test per warp before they
    load its row — the plain mirror of `splat_extent` in
    csrc/raster_common.cuh, operation for operation. Every offset (dx, dy)
    from the centre that passes the keep test (0 ≤ σ ≤ bound in float32) has
    |dx| ≤ hx and |dy| ≤ hy, with hx = √(2·bound·C/det), hy = √(2·bound·A/det)
    widened by the margins above. Rows with bound < 0 get an empty extent
    (−inf); rows whose conic is not safely positive definite, or that hold a
    non-finite value, an infinite one. Used by the tests and chip_smoke.py."""
    f32 = torch.float32
    rows = table_rows.to(f32)
    A, B, C = rows[..., COL_A], rows[..., COL_B], rows[..., COL_C]
    bound = rows[..., COL_BOUND]
    ac = A * C
    det_lo = (ac - B * B) - EXTENT_DET_MARGIN * ac
    q = 2.0 * bound
    hx = torch.sqrt((q * C) / det_lo) * EXTENT_REL_MARGIN + EXTENT_ABS_MARGIN
    hy = torch.sqrt((q * A) / det_lo) * EXTENT_REL_MARGIN + EXTENT_ABS_MARGIN
    ok = (
        (A > 0.0) & (C > 0.0) & (det_lo > 0.0) & (ac >= EXTENT_MIN_AC)
        & torch.isfinite(hx) & torch.isfinite(hy)
        & torch.isfinite(rows[..., COL_MX]) & torch.isfinite(rows[..., COL_MY])
    )
    inf = torch.full_like(hx, float("inf"))
    hx, hy = torch.where(ok, hx, inf), torch.where(ok, hy, inf)
    hx, hy = torch.where(bound < 0.0, -inf, hx), torch.where(bound < 0.0, -inf, hy)
    return torch.stack([rows[..., COL_MX], rows[..., COL_MY], hx, hy], dim=-1)


def extent_misses_rect(extent, x0, x1, y0, y1) -> torch.Tensor:
    """True where no pixel centre of the rectangle [x0, x1] × [y0, y1] can pass
    the keep test of a splat with this `splat_extent_torch` row: the kernels'
    per-warp cull (`warp_culls` in csrc/raster_common.cuh), which compares the
    rectangle's outermost rounded offsets from the centre with ±hx, ±hy.
    All arguments broadcast."""
    mx, my, hx, hy = extent.unbind(-1)
    return (x0 - mx > hx) | (x1 - mx < -hx) | (y0 - my > hy) | (y1 - my < -hy)


def tile_thread_pixels(tile_w: int, tile_h: int) -> np.ndarray:
    """(tile_w·tile_h, 2) int (x, y): the pixel of its tile that thread p of a
    raster kernel's block owns (`tile_pixel` in csrc/raster_common.cuh)."""
    p = np.arange(tile_w * tile_h)
    if tile_w % 8 == 0 and tile_h % 4 == 0:
        w, lane, blocks_x = p // 32, p % 32, tile_w // 8
        return np.stack([(w % blocks_x) * 8 + lane % 8, (w // blocks_x) * 4 + lane // 8], 1)
    return np.stack([p % tile_w, p // tile_w], 1)


def tile_warp_rects(tile_w: int, tile_h: int) -> np.ndarray:
    """(warps, 4) int [x0, x1, y0, y1]: the pixel rectangle, in pixels of the
    tile, that holds each warp of a raster kernel's block — the layout rule of
    csrc/raster_common.cuh (`tile_pixel`, `warp_rect`): 8×4 pixel blocks when
    tile_w % 8 == 0 and tile_h % 4 == 0, else 32 consecutive row-major pixels
    (whole rows once a warp wraps)."""
    npix = tile_w * tile_h
    rects = []
    for first in range(0, npix, 32):
        last = min(first + 31, npix - 1)
        if tile_w % 8 == 0 and tile_h % 4 == 0:
            w, blocks_x = first // 32, tile_w // 8
            x0, y0 = (w % blocks_x) * 8, (w // blocks_x) * 4
            rects.append((x0, x0 + 7, y0, y0 + 3))
        else:
            y0, y1 = first // tile_w, last // tile_w
            x0, x1 = (first % tile_w, last % tile_w) if y0 == y1 else (0, tile_w - 1)
            rects.append((x0, x1, y0, y1))
    return np.asarray(rects, dtype=np.int64)


def warp_pixel_rects(
    tiles: torch.Tensor, num_tiles_x: int, tile_w: int, tile_h: int, tile_row0: int = 0
) -> Tuple[torch.Tensor, ...]:
    """(x0, x1, y0, y1), each (len(tiles), warps) float32: the pixel-centre
    rectangle of every warp of each tile in GLOBAL image coordinates, as
    `warp_rect` in csrc/raster_common.cuh gets it (the tile's first global
    pixel row is (tile // num_tiles_x + tile_row0)·tile_h). With
    `splat_extent_torch` and `extent_misses_rect`, the plain mirror of the
    kernels' per-warp cull."""
    rects = torch.from_numpy(tile_warp_rects(tile_w, tile_h)).to(tiles.device)
    tx0 = ((tiles % num_tiles_x) * tile_w)[:, None]
    ty0 = ((torch.div(tiles, num_tiles_x, rounding_mode="floor") + tile_row0) * tile_h)[:, None]
    corners = (tx0 + rects[:, 0], tx0 + rects[:, 1], ty0 + rects[:, 2], ty0 + rects[:, 3])
    return tuple(c.to(torch.float32) + 0.5 for c in corners)


def composite_pairs(
    table: torch.Tensor,  # (N, 12) rank-ordered per-splat table
    pair_gauss: torch.Tensor,  # (B,) depth rank per pair
    tile_offsets: torch.Tensor,  # (T,) segment start per tile
    tile_counts: torch.Tensor,  # (T,) pairs per tile
    num_tiles_x: int,
    config: RenderConfig,
    tile_range: Optional[Tuple[int, int]] = None,
    tile_row0: int = 0,  # the band's first global tile row
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Composite the tiles [t0, t1) of `tile_range` (default: all) into
    (t1−t0, tw·th, 4) r,g,b,depth and (t1−t0, tw·th) T_final."""
    npix = config.tile_width * config.tile_height
    dev = table.device
    t0, t1 = (0, tile_offsets.shape[0]) if tile_range is None else tile_range
    nt = t1 - t0
    rows, local_tile, start, _, _, sigma = pair_pixel_sigma(
        table, pair_gauss, tile_offsets, tile_counts, num_tiles_x, config, (t0, t1),
        tile_row0,
    )
    b = rows.shape[0]
    alpha, _, _ = alpha_from_sigma(
        sigma, rows[:, COL_OP : COL_OP + 1],
        rows[:, COL_BOUND : COL_BOUND + 1].detach(), config.alpha_clamp,
    )

    # segmented exclusive prefix product along the pair axis, in log space.
    # The running sum spans every segment of the range and is then re-based
    # per segment, so it is carried in float64: in float32 the re-basing
    # cancels to an absolute error of ulp(|running sum|), which over a few
    # ten thousand pairs reaches 1e-3 in T (measured against the kernel).
    la = torch.log1p(-alpha)  # (b, npix)
    cum = torch.cumsum(la.double(), dim=0)
    excl = cum - la
    seg_first = (tile_offsets[t0:t1].to(torch.int64) - start).clamp(0, max(b - 1, 0))
    if b > 0:
        seg_start = excl[seg_first]  # (nt, npix) cumsum before each segment
        t_excl = torch.exp((excl - seg_start[local_tile]).float())
    else:
        t_excl = la
    weights = alpha * t_excl  # (b, npix)

    chans = rows[:, COL_R : COL_DEPTH + 1]  # (b, 4) r,g,b,depth
    tiles_rgbd = torch.zeros((nt, npix, 4), dtype=table.dtype, device=dev)
    tiles_rgbd = tiles_rgbd.index_add(
        0, local_tile, weights[..., None] * chans[:, None, :]
    )
    la_tot = torch.zeros((nt, npix), dtype=table.dtype, device=dev)
    la_tot = la_tot.index_add(0, local_tile, la)
    return tiles_rgbd, torch.exp(la_tot)


def image_to_tiles(
    img: torch.Tensor, tx_n: int, ty_n: int, tw: int, th: int
) -> torch.Tensor:
    """(H, W, C) image → (T, tw·th, C) tile-major pixels, the ragged right and
    bottom edges padded with zeros (the inverse of `tiles_to_image`)."""
    h, w, c = img.shape
    full = torch.zeros((ty_n * th, tx_n * tw, c), dtype=img.dtype, device=img.device)
    full[:h, :w] = img
    tiles = full.reshape(ty_n, th, tx_n, tw, c).permute(0, 2, 1, 3, 4)
    return tiles.reshape(ty_n * tx_n, th * tw, c)


def tile_batches(
    tile_offsets: torch.Tensor, tile_counts: torch.Tensor, max_batch_pairs: int
) -> Iterator[Tuple[int, int]]:
    """Consecutive tile ranges [t0, t1) of at most `max_batch_pairs` pairs each
    (one tile at least), from the segment ends (one host read of T integers)."""
    num_tiles = tile_offsets.shape[0]
    ends = (tile_offsets + tile_counts).cpu().numpy()
    t0 = 0
    while t0 < num_tiles:
        first = int(ends[t0 - 1]) if t0 > 0 else 0
        t1 = int(np.searchsorted(ends, first + max_batch_pairs, side="right"))
        t1 = min(max(t1, t0 + 1), num_tiles)
        yield t0, t1
        t0 = t1


def raster_forward_torch(
    table: torch.Tensor,
    pair_gauss: torch.Tensor,
    tile_offsets: torch.Tensor,
    tile_counts: torch.Tensor,
    width: int,
    height: int,
    config: RenderConfig,
    tile_row0: int = 0,
    max_batch_pairs: int = 1 << 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The raster stage in plain torch: same arguments and results as the
    CUDA wrapper `cuda_raster.raster_forward`. Returns (rgbd (H,W,4),
    T_final (H,W)), no background applied. A band (`tile_row0`, see the
    module docstring) is `height` rows of the frame.

    Tiles are composited in batches of at most `max_batch_pairs` pairs (one
    tile at least), bounding the (pairs × pixels) temporaries."""
    tw, th = config.tile_width, config.tile_height
    tx_n, ty_n = config.tiles_x(width), config.tiles_y(height)

    rgbd_parts, t_parts = [], []
    for t0, t1 in tile_batches(tile_offsets, tile_counts, max_batch_pairs):
        rgbd_t, tfin_t = composite_pairs(
            table, pair_gauss, tile_offsets, tile_counts, tx_n, config, (t0, t1),
            tile_row0,
        )
        rgbd_parts.append(rgbd_t)
        t_parts.append(tfin_t)
    rgbd = tiles_to_image(torch.cat(rgbd_parts), tx_n, ty_n, width, height, tw, th)
    t_final = tiles_to_image(
        torch.cat(t_parts)[..., None], tx_n, ty_n, width, height, tw, th
    )[..., 0]
    return rgbd, t_final


def raster_backward_torch(
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
    walked: Optional[torch.Tensor] = None,
    tile_row0: int = 0,
    max_batch_pairs: int = 1 << 15,
) -> torch.Tensor:
    """The raster stage's backward in plain torch, by the explicit formulas
    (no autograd): the plain version of the CUDA kernel raster_bwd. Returns
    (B, 10) float32 gradient rows of each PAIR's [mx,my,A,B,C,r,g,b,depth,op],
    in the pair list's order; rows of padding pairs are zero.

    Per pixel and pair i of a tile, front to back, with gC the four cotangents
    of r,g,b,depth and gT the cotangent of T_final:

        v_i = gC·c_i     w_i = α_i·T_i     Q = gC·C_total + gT·T_final
        dα_i = v_i·T_i − (Q − Σ_{j≤i} v_j·w_j) / (1 − α_i)
        dα_i = 0 unless keep_i and α_raw,i < α_clamp;   dσ_i = −dα_i·α_raw,i

    and the row's gradient is the sum over the tile's pixels of gC·w_i
    (channels), −dσ/op (opacity) and the chain through σ (centre and conic).
    `walked` ((T,) pairs the forward walked before its early exit) shortens
    each segment as the kernel does; None walks whole segments. Everything
    after α is carried in float64: the running sums span every segment of a
    batch and are re-based per segment, which cancels in float32.
    `tile_row0` places a band as in `raster_forward_torch`."""
    tw, th = config.tile_width, config.tile_height
    tx_n, ty_n = config.tiles_x(width), config.tiles_y(height)
    f64 = torch.float64

    def tiles(img):
        return image_to_tiles(img.to(f64), tx_n, ty_n, tw, th)

    gc_t = tiles(d_rgbd)  # (T, npix, 4)
    q_t = (gc_t * tiles(rgbd)).sum(-1) + (
        tiles(d_t_final[..., None]) * tiles(t_final[..., None])
    )[..., 0]  # (T, npix)

    out = torch.zeros((pair_gauss.shape[0], 10), dtype=table.dtype, device=table.device)
    for t0, t1 in tile_batches(tile_offsets, tile_counts, max_batch_pairs):
        rows, local_tile, start, px, py, sigma = pair_pixel_sigma(
            table, pair_gauss, tile_offsets, tile_counts, tx_n, config, (t0, t1),
            tile_row0,
        )
        b = rows.shape[0]
        if b == 0:
            continue
        tile = local_tile + t0
        alpha, alpha_raw, keep = alpha_from_sigma(
            sigma, rows[:, COL_OP : COL_OP + 1], rows[:, COL_BOUND : COL_BOUND + 1],
            config.alpha_clamp,
        )
        if walked is not None:
            index_in_tile = (
                torch.arange(b, device=rows.device) + start - tile_offsets[tile]
            )
            live = (index_in_tile < walked[tile])[:, None]
            keep = keep & live
            alpha = torch.where(live, alpha, 0.0)

        def seg_exclusive(x):  # per-segment exclusive prefix sum along pairs
            excl = torch.cumsum(x, dim=0) - x
            first = (tile_offsets[t0:t1].to(torch.int64) - start).clamp(0, b - 1)
            return excl - excl[first][local_tile]

        alpha = alpha.to(f64)
        la = torch.log1p(-alpha)
        t_before = torch.exp(seg_exclusive(la))  # (b, npix) T before pair i
        w = alpha * t_before

        chans = rows[:, COL_R : COL_DEPTH + 1].to(f64)  # (b, 4)
        gc = gc_t[tile]  # (b, npix, 4)
        v = (gc * chans[:, None, :]).sum(-1)
        contrib = v * w
        incl = seg_exclusive(contrib) + contrib
        da = v * t_before - (q_t[tile] - incl) / (1.0 - alpha)
        grad_live = keep & (alpha_raw < config.alpha_clamp)
        dsigma = torch.where(grad_live, -da * alpha_raw.to(f64), 0.0)

        dx = (px - rows[:, COL_MX : COL_MX + 1]).to(f64)
        dy = (py - rows[:, COL_MY : COL_MY + 1]).to(f64)
        s1 = dsigma.sum(1)
        sx, sy = (dsigma * dx).sum(1), (dsigma * dy).sum(1)
        sxx = (dsigma * dx * dx).sum(1)
        sxy = (dsigma * dx * dy).sum(1)
        syy = (dsigma * dy * dy).sum(1)
        A, B, C, op = (rows[:, c].to(f64) for c in (COL_A, COL_B, COL_C, COL_OP))
        d_op = torch.where(op > 0.0, -s1 / torch.where(op > 0.0, op, 1.0), 0.0)
        d_chans = (gc * w[..., None]).sum(1)  # (b, 4)
        out[start : start + b] = torch.stack(
            [-(A * sx + B * sy), -(C * sy + B * sx), 0.5 * sxx, sxy, 0.5 * syy,
             *d_chans.unbind(1), d_op],
            dim=1,
        ).to(table.dtype)
    return out


@torch.no_grad()
def rank_permutation(
    pair_gauss: torch.Tensor, rank_starts: torch.Tensor, n: int
) -> torch.Tensor:
    """(B,) int32 stable sort of the pair list by depth rank: position i of
    the sorted order holds pair `perm[i]`. Padding rows — those past the
    rank_starts[n] real pairs — are keyed to n and sort to the end; within a
    rank the pairs keep their tile order, so the order is fixed. The
    yardstick of the rank_perm kernel and of its plain version
    (`binning.rank_permutation_by_mask`), which give the same permutation
    without sorting the pairs again: the backward takes theirs."""
    b = pair_gauss.shape[0]
    real = torch.arange(b, device=pair_gauss.device) < rank_starts[n]
    keys = torch.where(real, pair_gauss, n)
    return torch.sort(keys, stable=True).indices.to(torch.int32)


def segment_sum_torch(
    rows: torch.Tensor,  # (B, C) per-pair rows, in the pair list's order
    perm: torch.Tensor,  # (B,) int32 `rank_permutation`
    rank_starts: torch.Tensor,  # (N+1,)
    n: int,
) -> torch.Tensor:
    """out[r] = Σ rows[perm[rank_starts[r] : rank_starts[r+1]]], (N, C): the
    plain version of the CUDA kernel segsum."""
    b = rows.shape[0]
    position = torch.arange(b, dtype=rank_starts.dtype, device=rows.device)
    # rank whose slice holds each sorted position; n for the padding rows
    rank = torch.searchsorted(rank_starts[1:].contiguous(), position, right=True)
    out = torch.zeros((n + 1, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    out.index_add_(0, rank.clamp_max(n), rows[perm])
    return out[:n]


# places (ranks plus sorted positions) of one warp's run in the segsum kernel:
# ITEMS of csrc/segsum.cu
SEGSUM_RUN_PLACES = 128


def segsum_runs(
    rank_starts: torch.Tensor,  # (N+1,)
    n: int,
    num_rows: int,  # B, the pair list's length (rank_starts[n] <= B)
    places: int = SEGSUM_RUN_PLACES,
) -> torch.Tensor:
    """The segsum kernel's owner rule, its plain mirror: (W, 4) int64, a row
    per warp run of the launch, W = ceil((n + num_rows) / places): (first
    rank the warp owns, ranks it owns, first position, end position).

    Rank r's place in the merge of ranks and sorted positions is
    r + rank_starts[r]; its positions follow it. Warp w owns the ranks whose
    place lies in [w * places, (w + 1) * places) and sums their whole
    segments, rank_starts[first] up to rank_starts[first + owned], however
    far past its run they reach. So every rank has one owner, the warps'
    positions follow one another, and a warp holds at most `places` ranks."""
    rs = rank_starts.to(torch.int64)
    dev = rs.device
    place = torch.arange(n, device=dev) + rs[:n]
    warps = -(-(n + num_rows) // places)
    runs = torch.arange(warps + 1, device=dev) * places
    edge = torch.searchsorted(place, runs)  # first rank placed at or past each run
    first, end = edge[:-1], edge[1:]
    return torch.stack([first, end - first, rs[first], rs[end]], dim=1)


RasterFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def bin_and_table(
    proj: ProjectedGaussians,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    width: int,
    height: int,
    config: RenderConfig,
    max_active: Optional[int] = None,
    tile_row0: int = 0,
    total_tiles_y: Optional[int] = None,
) -> Tuple[BinningResult, torch.Tensor]:
    """The raster stage's inputs: the binning and the per-splat table of
    its active depth ranks (the band arguments as in `render_tiled`)."""
    binning = bin_gaussians(
        proj, width, height, config, opacities=opacities, max_active=max_active,
        tile_row0=tile_row0, total_tiles_y=total_tiles_y,
    )
    table = build_splat_table(
        proj, colors, opacities, binning.order[: binning.num_active], config
    )
    return binning, table


def render_tiled(
    proj: ProjectedGaussians,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    width: int,
    height: int,
    config: RenderConfig,
    raster_fn: Optional[RasterFn] = None,
    max_active: Optional[int] = None,
    tile_row0: int = 0,
    total_tiles_y: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, BinningStats]:
    """Full tiled render: bin → per-splat table → raster → background.
    Returns (image (H,W,3), T_final (H,W), depth (H,W), BinningStats).

    `raster_fn(table, binning, width, height, config, tile_row0)` is the
    raster stage: by default this module's plain forward, differentiated by
    autograd; called through `cuda_raster`, the kernels behind their
    autograd.Function.

    `max_active`, `tile_row0`, `total_tiles_y`: one band of a frame of
    `total_tiles_y` tile rows (see `bin_gaussians`): means2d stay in global
    pixel coordinates, and this call renders the `height` rows from tile row
    `tile_row0`. The table holds the band's M active ranks only."""
    binning, table = bin_and_table(
        proj, colors, opacities, width, height, config,
        max_active=max_active, tile_row0=tile_row0, total_tiles_y=total_tiles_y,
    )
    if raster_fn is None:
        rgbd, t_final = raster_forward_torch(
            table, binning.pair_gauss, binning.tile_offsets, binning.tile_counts,
            width, height, config, tile_row0,
        )
    else:
        rgbd, t_final = raster_fn(table, binning, width, height, config, tile_row0)
    depth = rgbd[..., 3]
    image = rgbd[..., :3]
    if any(config.background):  # over black there is nothing to add
        bg = torch.tensor(config.background, dtype=torch.float32, device=rgbd.device)
        image = image + t_final[..., None] * bg
    return image, t_final, depth, BinningStats.of(binning)
