"""Tile binning: depth sort, gaussian→tile pair expansion, segmented offsets.

Counterpart of gaussian_splat_tpu/ops/binning.py with the same decisions, so
its integer outputs equal the reference's on the same projection inputs:

  * Gaussians are depth-sorted FIRST (stable argsort over N, culled last).
  * Two-tier tile rects: any splat whose K-capped rect area exceeds
    `small_tiles_per_gaussian` is big-tier eligible; the big tier has a static
    capacity, and eligible splats beyond it lose by area (ties to the lower
    index) and are shrunk to the small cap, counted in `tier_overflow`.
  * Oversized rects are shrunk isotropically around the mean's tile to fit
    their cap (`clamped_rects`).
  * The exact per-cell σ-bound test drops (gaussian, tile) cells whose
    pixel-center box the {σ ≤ bound} ellipse misses, with a +1e-4 margin.
  * Budget truncation drops WHOLE gaussians from the far end of the depth
    order (`overflow`), which keeps per-rank pair counts — `rank_starts` —
    exact.
  * One sort of (tile, depth rank) keys yields per-tile front-to-back
    segments.

What differs from the reference, by design: the sort key is ONE int64
`(tile << 32) | rank` sorted by `torch.sort` (no 32-bit packing limit and no
two-key fallback), the rect columns are gathered directly rather than packed
into a code word, the pair list is exactly `pair_budget` long (the CUDA
kernel needs no alignment padding), and the sort's indices are kept
(`pair_src`), with the cells the keys were made from (`kept`): from them
`rank_permutation_by_mask`, the rank_perm kernel's rule, gives the backward
the pairs' rank order, which the reference sorts again.

`bin_gaussians` runs the plain version, `bin_gaussians_torch`, on CPU
tensors; on CUDA tensors it runs the kernels of csrc/binning.cu (or raises),
which give the same outputs bit for bit with no sort but the depth argsort:
the ranks are already in depth order and each (tile, rank) occurs once, so a
kept cell's place in the tile-major list is its tile's offset plus the kept,
in-budget cells of its tile with a lower rank, a counting sort on the tile
id (see the source's notes).

The sharded path (parallel/sharded_render.py) bins one horizontal band of a
taller frame: `total_tiles_y` is the global tile-row count and `tile_row0`
the band's first global row, so rects, K-cap shrinks, tier flags and the
σ-bound cell test are the single-card decisions on the global grid, clipped
to the band afterwards; `max_active` lets only the first m depth ranks emit
(out-of-band splats sort last), and valid splats past them are counted in
`dropped_gaussians`. Then the slot layout (`emission_rows(m)`), `rank_starts`
and the per-splat table cover the m active ranks only.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from gaussian_splat_tpu_torch.config import RenderConfig
from gaussian_splat_tpu_torch.ops.falloff import log_alpha_skip, sigma_bound
from gaussian_splat_tpu_torch.ops.projection import ProjectedGaussians


class KeptCells(NamedTuple):
    """Which emission slots (`emission_rows(M)`) hold a pair, as
    `bin_gaussians` decided before its sort: the rank_perm kernel reads each
    row's kept cells here instead of marking them again from `pair_src`."""

    small: torch.Tensor  # (M, k_small) bool, row r = depth rank r
    big: torch.Tensor  # (big, k_big) bool, the big tier's rows
    big_ranks: torch.Tensor  # (big,) int32 depth rank of each big row (rows
    #   with no kept cell may hold any index)


class BinningResult(NamedTuple):
    order: torch.Tensor  # (N,) int64 depth argsort: sorted_i -> original index
    pair_gauss: torch.Tensor  # (B,) int32 index into the *depth-sorted* arrays
    #   (0 on padding rows — mask with pair_tile)
    pair_tile: torch.Tensor  # (B,) int32 tile id, == num_tiles on padding rows
    tile_offsets: torch.Tensor  # (T,) int32 segment start per tile
    tile_counts: torch.Tensor  # (T,) int32 pairs per tile
    num_pairs: torch.Tensor  # () int32 valid pairs before budget truncation
    overflow: torch.Tensor  # () int32 pairs dropped by the budget
    clamped_rects: torch.Tensor  # () int32 gaussians whose tile rect was shrunk
    #   by the per-gaussian K cap or the tier-capacity overflow
    rank_starts: torch.Tensor  # (M+1,) int32 exclusive cumsum of per-rank pair
    #   counts: pairs of depth-rank r number rank_starts[r+1]−rank_starts[r].
    #   M = min(max_active, N) ranks may emit (N without max_active); the
    #   per-splat table holds these M ranks (`num_active`)
    tier_overflow: torch.Tensor  # () int32 big-tier-ELIGIBLE gaussians denied a
    #   big slot because the big-tier capacity overflowed
    pair_src: torch.Tensor  # (B,) int32 emission slot each pair was sorted from
    #   (see `rank_permutation_by_mask`); 0 on padding rows, which no one
    #   reads (rank_perm masks positions ≥ rank_starts[M])
    dropped_gaussians: torch.Tensor  # () int32 valid gaussians beyond the
    #   `max_active` cap (sharded path: in-band splats a device had to drop
    #   because its band capacity overflowed; 0 when max_active is None)
    kept: KeptCells  # the slots behind `pair_src`: the keys' own masks, kept
    #   (no device work beyond the sort's inputs)

    @property
    def num_active(self) -> int:
        """M, the depth ranks that may emit pairs: the per-splat table's rows
        are `order[:M]`."""
        return self.rank_starts.shape[0] - 1


class EmissionRows(NamedTuple):
    """Where `bin_gaussians` emits its cells before the sort: `small` rows of
    `k_small` slots (row r is depth rank r), then `big` rows of `k_big` (the
    big tier, ranks in `_top_indices` order); a row emits its rect's cells in
    row-major order. `pair_src` indexes these slots."""

    small: int
    k_small: int
    big: int
    k_big: int

    @property
    def slots(self) -> int:
        return self.small * self.k_small + self.big * self.k_big

    @property
    def mask_words(self) -> int:
        """32-bit words of the rank_perm kernel's kept-cell bitmask:
        ceil(k / 32) a row (`rank_permutation_by_mask`)."""
        return self.small * -(-self.k_small // 32) + self.big * -(-self.k_big // 32)


def emission_rows(m: int, config: RenderConfig) -> EmissionRows:
    """The emission layout of `bin_gaussians` when m depth ranks may emit
    (m = N without `max_active`): m small rows and the big tier's capacity
    for m."""
    return EmissionRows(
        m, config.small_tiles_per_gaussian, config.big_capacity(m),
        config.max_tiles_per_gaussian,
    )


class BinningStats(NamedTuple):
    """Scalar telemetry extracted from a BinningResult (0-d tensors on the
    binning's device: reading one is a device synchronisation). The sharded
    path returns one row per band: each field (D,)."""

    num_pairs: torch.Tensor  # valid pairs before budget truncation
    overflow: torch.Tensor  # pairs dropped by the pair budget
    clamped_rects: torch.Tensor  # shrunk tile rects
    dropped_gaussians: torch.Tensor  # splats dropped by max_active (and, on
    #   the all_to_all path, by the send buffers)
    tier_overflow: torch.Tensor  # big-tier capacity misses

    @classmethod
    def of(cls, b: BinningResult) -> "BinningStats":
        return cls(b.num_pairs, b.overflow, b.clamped_rects, b.dropped_gaussians,
                   b.tier_overflow)


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def _count(mask: torch.Tensor) -> torch.Tensor:
    return _i32(torch.sum(mask))


def _top_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores, ties to the LOWER index first — the
    order `jax.lax.top_k` guarantees and `torch.topk` does not, and the one
    that decides who loses a big-tier slot when the tier overflows."""
    return torch.sort(score, descending=True, stable=True).indices[:k]


def quantize_extent_up(x: torch.Tensor) -> torch.Tensor:
    """Round a billboard extent UP to the 1/256-px grid, where mean − extent
    is exact for coordinates < 4096, so every path floors the same rect.
    Rounding UP only enlarges the exact ellipse AABB."""
    return torch.ceil(x * 256.0) * (1.0 / 256.0)


def _tile_index(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Clamp a float tile coordinate to [lo, hi], then convert: clamping first
    keeps the conversion defined for the huge coordinates of culled splats."""
    return _i32(torch.clamp(x, lo, hi))


def tile_rects(
    means2d: torch.Tensor,
    radii: torch.Tensor,
    valid: torch.Tensor,
    width: int,
    height: int,
    config: RenderConfig,
    extents: Optional[torch.Tensor] = None,
    total_tiles_y: Optional[int] = None,
):
    """Per-gaussian tile rectangle [tx0,tx1)×[ty0,ty1), capped to the
    per-gaussian tile budget. Returns (tx0, ty0, rect_w, rect_h, clamped_count).

    `extents` (N, 2), when given, is the exact per-axis ellipse AABB from
    projection — strictly tighter than the circular `radii`.

    `total_tiles_y`: the GLOBAL tile-row count when this call serves one
    band of a taller frame. Rects and the K-cap shrink are then computed on
    the global grid, so every band makes the single-card decision; the
    caller clips to its band afterwards (`bin_gaussians`)."""
    tw, th = config.tile_width, config.tile_height
    tx_n = config.tiles_x(width)
    ty_n = config.tiles_y(height) if total_tiles_y is None else total_tiles_y

    if extents is not None:
        rx = quantize_extent_up(extents[:, 0])
        ry = quantize_extent_up(extents[:, 1])
    else:
        rx = ry = radii.to(torch.float32)
    mx, my = means2d[:, 0], means2d[:, 1]

    tx0 = _tile_index(torch.floor((mx - rx) / tw), 0, tx_n)
    tx1 = _tile_index(torch.ceil((mx + rx) / tw), 0, tx_n)
    ty0 = _tile_index(torch.floor((my - ry) / th), 0, ty_n)
    ty1 = _tile_index(torch.ceil((my + ry) / th), 0, ty_n)

    w = torch.where(valid, tx1 - tx0, 0)
    h = torch.where(valid, ty1 - ty0, 0)

    tx0, ty0, w, h, clamped = _shrink_to_cap(
        tx0, ty0, w, h, config.max_tiles_per_gaussian, mx, my, tw, th, tx_n, ty_n
    )
    w = torch.where(valid, w, 0)
    h = torch.where(valid, h, 0)
    return tx0, ty0, w, h, _count(clamped & valid)


def _shrink_to_cap(tx0, ty0, w, h, cap, mx, my, tw, th, tx_n, ty_n, apply=None):
    """Shrink rects with area > cap isotropically around the mean's tile:
    floor(w·s)·floor(h·s) ≤ w·h·(cap/area) = cap for s = sqrt(cap/area).
    `apply` optionally restricts which gaussians are eligible for shrinking.
    Returns (tx0, ty0, w, h, shrunk_mask)."""
    area = w * h
    needs = area > cap
    if apply is not None:
        needs = needs & apply
    s = torch.sqrt(cap / torch.clamp_min(area, 1).to(torch.float32))
    w_c = torch.clamp_min(_i32(w.to(torch.float32) * s), 1)
    h_c = torch.clamp_min(_i32(h.to(torch.float32) * s), 1)
    # Thin rects can violate the cap after the floor-and-bump above (a 64×1
    # rect with cap 16: h_c floors to 0 → bumped to 1 while w_c=32). Re-clamp
    # so w_c·h_c ≤ cap ALWAYS holds — rank_starts counts the full rect area.
    w_c = torch.minimum(w_c, cap // torch.clamp_min(h_c, 1))
    h_c = torch.minimum(h_c, cap // torch.clamp_min(w_c, 1))
    w_c = torch.clamp_min(w_c, 1)
    h_c = torch.clamp_min(h_c, 1)
    cx = _tile_index(torch.floor(mx / tw), 0, tx_n - 1)
    cy = _tile_index(torch.floor(my / th), 0, ty_n - 1)
    tx0_c = torch.minimum(torch.clamp_min(cx - (w_c - 1) // 2, 0), tx_n - w_c)
    ty0_c = torch.minimum(torch.clamp_min(cy - (h_c - 1) // 2, 0), ty_n - h_c)
    return (
        torch.where(needs, tx0_c, tx0),
        torch.where(needs, ty0_c, ty0),
        torch.where(needs, w_c, w),
        torch.where(needs, h_c, h),
        needs,
    )


def effective_rects(
    means2d: torch.Tensor,
    radii: torch.Tensor,
    valid: torch.Tensor,
    width: int,
    height: int,
    config: RenderConfig,
    n_active: Optional[int] = None,
    extents: Optional[torch.Tensor] = None,
    total_tiles_y: Optional[int] = None,
):
    """Two-tier per-gaussian rects as used by `bin_gaussians`, in ORIGINAL
    index order.

    Tier membership is a per-gaussian THRESHOLD (K-capped rect area >
    `small_tiles_per_gaussian`); the big tier keeps a STATIC capacity
    `config.big_capacity(n_active or N)`, and eligible splats beyond it lose
    deterministically by area and are shrunk to the small cap, counted in
    `tier_overflow` — zero in any sane configuration, and on the sharded
    path the sentinel that every band made the single-card decision.
    `n_active` sizes the capacity when only that many depth ranks may emit
    (`max_active`); `total_tiles_y` as in `tile_rects`: rects, shrinks and
    tier flags all on the global grid.
    Returns (tx0, ty0, w, h, is_big, clamped, tier_overflow)."""
    tw, th = config.tile_width, config.tile_height
    tx_n = config.tiles_x(width)
    ty_n = config.tiles_y(height) if total_tiles_y is None else total_tiles_y
    n = means2d.shape[0]
    n_eff = n if n_active is None else min(n_active, n)
    mx, my = means2d[:, 0], means2d[:, 1]

    tx0, ty0, w, h, clamped_big = tile_rects(
        means2d, radii, valid, width, height, config, extents=extents,
        total_tiles_y=total_tiles_y,
    )
    area = w * h  # 0 on invalid rows

    m_big = config.big_capacity(n_eff)
    eligible = area > config.small_tiles_per_gaussian
    big_idx = _top_indices(torch.where(eligible, area, 0), m_big)
    sel = eligible[big_idx]  # capacity slots actually holding eligible splats
    is_big = torch.zeros((n,), dtype=torch.bool, device=means2d.device)
    is_big[big_idx] = sel
    tier_overflow = _count(eligible) - _count(sel)

    tx0, ty0, w, h, shrunk = _shrink_to_cap(
        tx0, ty0, w, h, config.small_tiles_per_gaussian,
        mx, my, tw, th, tx_n, ty_n, apply=~is_big,
    )
    clamped = clamped_big + _count(shrunk & valid)
    return tx0, ty0, w, h, is_big, clamped, tier_overflow


def _cell_sigma_min(tx, ty_global, mx, my, A2, B, C2, tw, th):
    """Exact min of σ = A2·dx² + B·dx·dy + C2·dy² over a tile's pixel-center
    box [tx·tw+0.5, tx·tw+tw−0.5] × [ty·th+0.5, ty·th+th−0.5], ty the tile's
    row on the GLOBAL grid.

    The box-constrained minimum of a positive-definite quadratic is 0 if the
    mean is inside, else it lies on the boundary: evaluate the 1-D clamped
    minimizer on each of the four edges and take the min."""
    x0 = tx.to(torch.float32) * tw + 0.5
    y0 = ty_global.to(torch.float32) * th + 0.5
    dx0 = x0 - mx
    dx1 = dx0 + (tw - 1.0)
    dy0 = y0 - my
    dy1 = dy0 + (th - 1.0)
    inside = (dx0 <= 0.0) & (0.0 <= dx1) & (dy0 <= 0.0) & (0.0 <= dy1)
    inv2c = 1.0 / torch.clamp_min(2.0 * C2, 1e-12)
    inv2a = 1.0 / torch.clamp_min(2.0 * A2, 1e-12)

    def sig(dx, dy):
        return (A2 * dx) * dx + (C2 * dy + B * dx) * dy

    def edge_x(dx):  # fixed dx, minimize over dy
        dy = torch.minimum(torch.maximum(-B * dx * inv2c, dy0), dy1)
        return sig(dx, dy)

    def edge_y(dy):  # fixed dy, minimize over dx
        dx = torch.minimum(torch.maximum(-B * dy * inv2a, dx0), dx1)
        return sig(dx, dy)

    smin = torch.minimum(
        torch.minimum(edge_x(dx0), edge_x(dx1)),
        torch.minimum(edge_y(dy0), edge_y(dy1)),
    )
    return torch.where(inside, 0.0, smin)


@torch.no_grad()
def bin_gaussians(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    config: RenderConfig,
    opacities: Optional[torch.Tensor] = None,
    max_active: Optional[int] = None,
    tile_row0: int = 0,
    total_tiles_y: Optional[int] = None,
) -> BinningResult:
    """Full binning pass; integer outputs, no gradient. CUDA tensors go to
    the kernels of csrc/binning.cu (or raise), CPU tensors to the plain
    version, `bin_gaussians_torch`, whose docstring has the arguments."""
    if tile_row0 and total_tiles_y is None:
        raise ValueError("tile_row0 places a band in a frame of total_tiles_y rows")
    if proj.means2d.is_cuda:
        return _bin_gaussians_cuda(proj, width, height, config, opacities, max_active,
                                   tile_row0, total_tiles_y)
    return bin_gaussians_torch(proj, width, height, config, opacities, max_active,
                               tile_row0, total_tiles_y)


@torch.no_grad()
def bin_gaussians_torch(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    config: RenderConfig,
    opacities: Optional[torch.Tensor] = None,
    max_active: Optional[int] = None,
    tile_row0: int = 0,
    total_tiles_y: Optional[int] = None,
) -> BinningResult:
    """The plain binning pass (the kernels' plain version); integer outputs,
    no gradient.

    `opacities` ((N,) original order) enables the EXACT per-cell σ-bound tile
    test — a (gaussian, tile) pair whose support ellipse {σ ≤ bound} does not
    reach the tile's pixel-center box is dropped at expansion time.
    Output-identical (such pairs contribute α≡0 in every backend). Without it
    every rect cell is kept.

    `max_active` caps how many depth-sorted gaussians may emit pairs: the
    sharded path marks out-of-band splats invalid (they sort last) and passes
    its band capacity here, so the expansion and the pair sort run over M
    rows instead of N. Valid gaussians beyond the cap are counted in
    `dropped_gaussians`.

    `total_tiles_y` + `tile_row0`: GLOBAL-grid banding for the sharded path.
    Rects, K-cap shrinks, tier membership and the σ-bound cell test use the
    global `total_tiles_y`-row grid (the single-card decisions: means2d stay
    in global pixel coordinates); the rects are then clipped to the band of
    `tiles_y(height)` rows from `tile_row0`, and tile ids are band-local."""
    dev = proj.means2d.device
    tx_n = config.tiles_x(width)
    ty_n = config.tiles_y(height)
    num_tiles = tx_n * ty_n
    if tile_row0 and total_tiles_y is None:
        raise ValueError("tile_row0 places a band in a frame of total_tiles_y rows")
    n = proj.means2d.shape[0]
    m = n if max_active is None else min(max_active, n)
    emission = emission_rows(m, config)
    K, k_small, m_big = emission.k_big, emission.k_small, emission.big
    tw, th = config.tile_width, config.tile_height

    # --- 1. depth sort (near → far); culled splats sort last ----------------
    depth_key = torch.where(proj.valid, proj.depths, torch.inf)
    order = torch.argsort(depth_key, stable=True)

    # --- 2. two-tier tile rects (original order), gathered into depth order -
    tx0_o, ty0_o, w_o, h_o, is_big_o, clamped, tier_ovf = effective_rects(
        proj.means2d, proj.radii, proj.valid, width, height, config,
        n_active=m, extents=proj.extents, total_tiles_y=total_tiles_y,
    )
    tx0, ty0, w, h = tx0_o[order], ty0_o[order], w_o[order], h_o[order]
    is_big = is_big_o[order]
    valid = proj.valid[order]
    if total_tiles_y is not None:
        # band clip on the global grid: [ty0, ty0+h) ∩ [row0, row0+ty_n),
        # re-based to band-local rows; shrinks, tier flags and w came from
        # the global rect, so the geometry is the single-card decision
        ty1 = torch.clamp(ty0 + h - tile_row0, 0, ty_n)
        ty0 = torch.clamp(ty0 - tile_row0, 0, ty_n)
        h = ty1 - ty0
    area = w * h
    if m < n:
        dropped = _count(valid[m:])
        area[m:] = 0
    else:
        dropped = torch.zeros((), dtype=torch.int32, device=dev)

    # rank-space index list of the big tier: ≤ m_big set bits first (lowest
    # rank first), unused capacity slots filled with non-big rows and masked
    big_idx = _top_indices(_i32(is_big), m_big)
    big_used = is_big[big_idx]

    ranks = torch.arange(m, dtype=torch.int32, device=dev)

    def cells(tx0e, ty0e, we, kk):
        """(rows, kk) tile coordinates of each rect's kk first cells."""
        kidx = torch.arange(kk, dtype=torch.int32, device=dev)[None, :]
        w_safe = torch.clamp_min(we, 1)[:, None]
        return tx0e[:, None] + kidx % w_safe, ty0e[:, None] + kidx // w_safe, kidx

    cells_s = cells(tx0[:m], ty0[:m], w[:m], k_small)
    cells_b = cells(tx0[big_idx], ty0[big_idx], w[big_idx], K)
    area_small_raw = torch.where(is_big, 0, area)[:m]
    area_big_raw = torch.where(big_used, area[big_idx], 0)
    mask_s = cells_s[2] < area_small_raw[:, None]
    mask_b = cells_b[2] < area_big_raw[:, None]

    # --- 2a. exact per-cell σ-bound tile test (optional) --------------------
    # The +1e-4 absolute margin on the bound makes a rounding kill of a
    # genuinely contributing pair impossible (σ evaluation noise is ~1e-6).
    if opacities is not None:
        mx_s = proj.means2d[order, 0]
        my_s = proj.means2d[order, 1]
        A2_s = 0.5 * proj.conics[order, 0]
        B_s = proj.conics[order, 1]
        C2_s = 0.5 * proj.conics[order, 2]
        bound_s = sigma_bound(
            opacities[order], valid, config.sigma_cutoff, config.alpha_skip
        ) + 1e-4

        def reaches(cell, rows):
            smin = _cell_sigma_min(
                cell[0], cell[1] + tile_row0,
                mx_s[rows][:, None], my_s[rows][:, None],
                A2_s[rows][:, None], B_s[rows][:, None], C2_s[rows][:, None],
                tw, th,
            )
            return smin <= bound_s[rows][:, None]

        mask_s = mask_s & reaches(cells_s, slice(0, m))
        mask_b = mask_b & reaches(cells_b, big_idx)
        # per-rank survivor counts replace the raw rect areas downstream
        area = _i32(torch.sum(mask_s, dim=1))
        if m < n:  # ranks past the cap emit nothing
            area = torch.cat([area, area.new_zeros((n - m,))])
        area = area.index_add(0, big_idx, _i32(torch.sum(mask_b, dim=1)))

    # --- 2b. rank-deterministic budget truncation ---------------------------
    # Drop WHOLE gaussians from the far end of the depth order until the pair
    # budget fits: overflow is semantically clean (the farthest splats vanish)
    # and per-rank pair counts stay exact.
    budget = min(config.pair_budget(m), emission.slots)
    ends_all = torch.cumsum(area, dim=0)
    fits = ends_all <= budget
    eff_area = torch.where(fits, area, 0)
    num_pairs = _i32(torch.sum(area))
    overflow = num_pairs - _i32(torch.sum(eff_area))
    rank_starts = torch.cat(
        [torch.zeros((1,), dtype=torch.int32, device=dev),
         _i32(torch.cumsum(eff_area[:m], dim=0))]
    )

    # --- 3. padded pair expansion, then ONE sort -----------------------------
    # key = (tile << 32) | depth rank; cells that emit nothing carry the
    # sentinel tile id num_tiles and sort to the end
    sentinel = num_tiles << 32

    def keys(cell, ok, rank_e):
        tile = (cell[1] * tx_n + cell[0]).to(torch.int64)
        key = (tile << 32) | rank_e[:, None].to(torch.int64)
        return torch.where(ok, key, sentinel).reshape(-1)

    kept = KeptCells(mask_s & fits[:m, None], mask_b & fits[big_idx][:, None], _i32(big_idx))
    flat_keys = torch.cat([
        keys(cells_s, kept.small, ranks),
        keys(cells_b, kept.big, kept.big_ranks),
    ])
    sorted_keys, src = torch.sort(flat_keys)
    sorted_keys = sorted_keys[:budget]
    pair_tile = _i32(sorted_keys >> 32)
    pair_gauss = torch.where(
        pair_tile < num_tiles, _i32(sorted_keys & 0xFFFFFFFF), 0
    )

    # --- 4. per-tile segment boundaries -------------------------------------
    boundaries = _i32(torch.searchsorted(
        pair_tile, torch.arange(num_tiles + 1, dtype=torch.int32, device=dev)
    ))

    return BinningResult(
        order=order,
        pair_gauss=pair_gauss,
        pair_tile=pair_tile,
        tile_offsets=boundaries[:-1].contiguous(),
        tile_counts=boundaries[1:] - boundaries[:-1],
        num_pairs=num_pairs,
        overflow=overflow,
        clamped_rects=clamped,
        rank_starts=rank_starts,
        tier_overflow=tier_ovf,
        pair_src=torch.where(pair_tile < num_tiles, _i32(src[:budget]), 0),
        dropped_gaussians=dropped,
        kept=kept,
    )


# the kernels of csrc/binning.cu, one launch of each a call of
# `bin_gaussians` on CUDA tensors (counted in cuda_raster.launch_counts)
KERNELS = ("bin_rects", "bin_count", "bin_offsets", "bin_scatter")
MAX_TILES_ACROSS = 1 << 15  # a rect's tile columns and rows are 15-bit fields
MAX_K_SMALL = 32  # a small row's kept cells are one 32-bit word
MAX_K_BIG = 8192  # bin_rects holds a histogram of the areas ≤ K in shared memory


def _scratch_bytes(n: int, m: int, tiles: int, k_big: int, m_big: int) -> int:
    from gaussian_splat_tpu_torch import _build

    fn = _build.load_library("binning").binning_scratch_bytes
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int]
        fn.restype = ctypes.c_longlong
    return fn(n, m, tiles, k_big, m_big)


def _rows_arg(name: str, x: torch.Tensor, like: torch.Tensor, dtype: torch.dtype, shape):
    """Checks an input the kernels read row by row (a view with a row stride
    is taken as it is) and returns its row stride in elements."""
    if x.device != like.device:
        raise ValueError(f"{name} is on {x.device}, expected {like.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if x.shape != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if x.dim() == 2 and x.stride(1) != 1:
        raise ValueError(f"{name}: expected unit stride along its last dimension")
    return x.stride(0)


def _pieces(dtype: torch.dtype, device, sizes):
    """1-D tensors of the given sizes cut from one allocation, each starting
    16-byte aligned."""
    per = 16 // torch.empty((), dtype=dtype).element_size()
    padded = [-(-size // per) * per for size in sizes]
    buf = torch.empty((sum(padded),), dtype=dtype, device=device)
    return [piece[:size] for piece, size in zip(buf.split(padded), sizes)]


def _bin_gaussians_cuda(proj, width, height, config, opacities, max_active, tile_row0,
                        total_tiles_y) -> BinningResult:
    """`bin_gaussians` through csrc/binning.cu: the depth argsort, then one
    launch of the chain. Raises on what the kernels do not take."""
    from gaussian_splat_tpu_torch.ops import cuda_raster

    means2d = proj.means2d
    n = means2d.shape[0] if means2d.dim() == 2 else -1
    strides = [_rows_arg("means2d", means2d, means2d, torch.float32, (n, 2))]
    m = n if max_active is None else min(max_active, n)
    emission = emission_rows(m, config)
    k_small, k_big, m_big = emission.k_small, emission.k_big, emission.big
    tx_n, ty_n = config.tiles_x(width), config.tiles_y(height)
    ty_global = ty_n if total_tiles_y is None else total_tiles_y
    num_tiles = tx_n * ty_n
    if m < 1:
        raise ValueError(f"the binning kernels need a splat that may emit, got {m}")
    if not 1 <= k_small <= MAX_K_SMALL or not 1 <= k_big <= MAX_K_BIG:
        raise ValueError(f"the binning kernels take 1 ≤ small_tiles_per_gaussian ≤ "
                         f"{MAX_K_SMALL} and 1 ≤ max_tiles_per_gaussian ≤ {MAX_K_BIG}")
    if max(tx_n, ty_global) >= MAX_TILES_ACROSS or emission.slots >= 2**31:
        raise ValueError(f"the binning kernels take fewer than {MAX_TILES_ACROSS} tiles "
                         f"across and 2^31 emission slots, got {tx_n}x{ty_global} tiles and "
                         f"{emission.slots} slots")
    extents = proj.extents
    if extents is not None:
        strides.append(_rows_arg("extents", extents, means2d, torch.float32, (n, 2)))
    else:
        cuda_raster._check("radii", proj.radii, torch.int32, (n,), means2d, align=4)
        strides.append(0)
    cuda_raster._check("valid", proj.valid, torch.bool, (n,), means2d, align=1)
    if opacities is not None:
        strides.append(_rows_arg("conics", proj.conics, means2d, torch.float32, (n, 3)))
        strides.append(_rows_arg("opacities", opacities, means2d, torch.float32, (n,)))
    else:
        strides += [0, 0]
    budget = min(config.pair_budget(m), emission.slots)
    launch = cuda_raster._launcher("binning")
    dev = means2d.device
    with cuda_raster._on(dev):
        depth_key = torch.where(proj.valid, proj.depths, torch.inf)
        order = torch.argsort(depth_key, stable=True)
        # the int32 outputs in one allocation, the bool ones in another (each
        # torch.empty costs the call microseconds of the host's time), every
        # piece 16-byte aligned as the kernels that read them check
        # (pair_gauss, pair_tile, pair_src) and (tile_offsets, tile_counts)
        # as rows padded to 4 ints, as the chain lays them out. The
        # sentinels are an allocation of their own: callers keep every
        # render's stats, which must not hold the pair list alive.
        b4, t4 = -(-budget // 4) * 4, -(-num_tiles // 4) * 4
        pairs, tiles, rank_starts, big_ranks = _pieces(
            torch.int32, dev, [3 * b4, 2 * t4, m + 1, m_big])
        scalars = torch.empty((5,), dtype=torch.int32, device=dev)
        pairs, tiles = pairs.view(3, b4)[:, :budget], tiles.view(2, t4)[:, :num_tiles]
        kept_small, kept_big = _pieces(torch.bool, dev, [m * k_small, m_big * k_big])
        scratch = torch.empty((_scratch_bytes(n, m, num_tiles, k_big, m_big),),
                              dtype=torch.uint8, device=dev)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        err = launch(
            means2d.data_ptr(), ptr(extents), proj.radii.data_ptr(), proj.valid.data_ptr(),
            ptr(proj.conics if opacities is not None else None), ptr(opacities),
            order.data_ptr(), pairs.data_ptr(), tiles.data_ptr(), rank_starts.data_ptr(),
            kept_small.data_ptr(), kept_big.data_ptr(), big_ranks.data_ptr(),
            scalars.data_ptr(), scratch.data_ptr(), n, m, tx_n, ty_n, ty_global, tile_row0,
            config.tile_width, config.tile_height, k_small, k_big, m_big, budget, *strides,
            config.sigma_cutoff, log_alpha_skip(config.alpha_skip), cuda_raster._stream(dev),
        )
    if err != 0:
        raise RuntimeError(f"binning launch failed: CUDA error {err}")
    for name in KERNELS:
        cuda_raster.launch_counts[name] += 1
    return BinningResult(
        order=order, pair_gauss=pairs[0], pair_tile=pairs[1], tile_offsets=tiles[0],
        tile_counts=tiles[1], num_pairs=scalars[0], overflow=scalars[1],
        clamped_rects=scalars[2], rank_starts=rank_starts, tier_overflow=scalars[3],
        pair_src=pairs[2], dropped_gaussians=scalars[4],
        kept=KeptCells(kept_small.view(m, k_small), kept_big.view(m_big, k_big), big_ranks),
    )


def slot_divmod_magic(d: int):
    """(m, s) with x // d == (x * m) >> s for every 0 <= x < 2**31, d >= 1:
    s = 31 + ceil(log2 d), m = ceil(2**s / d) < 2**32 (Granlund and
    Montgomery's round-up rule: m * d - 2**s < d <= 2**(s - 31)). The
    rank_perm kernel finds a slot's row so, with no divide."""
    s = 31 + (d - 1).bit_length()
    return -(-(1 << s) // d), s


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """__popc of int64 values in [0, 2**32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


@torch.no_grad()
def rank_permutation_by_mask(
    pair_src: torch.Tensor,  # (B,) int32 BinningResult.pair_src
    rank_starts: torch.Tensor,  # (M+1,) int32
    kept: KeptCells,  # BinningResult.kept
    config: RenderConfig,
) -> torch.Tensor:
    """(B,) int32, element for element what `tile_raster.rank_permutation`
    sorts out of the pair list — position i of the rank-sorted order holds
    pair perm[i] — rebuilt from `bin_gaussians`' own sort with no second one,
    by the rank_perm kernel's rule (csrc/rank_perm.cu) step for step: the
    plain version that `cuda_raster.rank_permutation_from_sort` runs on CPU
    tensors. The layout is `emission_rows(M)`, M read from rank_starts.

    A row of the emission slots emits its rect's cells in row-major order,
    so its tile ids rise with the slot, and the tile-major pair list holds a
    splat's pairs in the order of their slots: pair j of rank r sits at
    rank_starts[r] + (kept cells of its row before its own).

    `pack`: each emission row's kept cells become ceil(k / 32) 32-bit words
    (`EmissionRows.mask_words`; word i holds cells 32i..32i+31, cell c as bit
    c % 32), each with a record (the row's rank start plus the kept cells of
    its earlier words, the bits). `place`: pair j of slot s — row and column
    by `slot_divmod_magic` — goes to its word's record's place plus the
    popcount of the bits below its own; padding pairs keep their places."""
    n = rank_starts.shape[0] - 1
    emission = emission_rows(n, config)
    dev = pair_src.device
    starts = rank_starts.long()
    records = []
    for cells, ranks in ((kept.small, torch.arange(n, device=dev)), (kept.big, kept.big_ranks)):
        rows, k = cells.shape
        words = -(-k // 32)
        padded = torch.nn.functional.pad(cells.long(), (0, 32 * words - k)).view(rows, words, 32)
        bits = (padded << torch.arange(32, device=dev)).sum(-1)
        counts = padded.sum(-1)
        # a row with no kept cell is read by no pair (its rank may be any index)
        any_kept = counts.sum(-1) > 0
        start = torch.where(any_kept, starts[torch.where(any_kept, ranks.long(), 0)], 0)
        places = start[:, None] + torch.cumsum(counts, -1) - counts
        records.append(torch.stack([places, bits], -1).view(-1, 2))
    records = torch.cat([*records, torch.zeros((1, 2), dtype=torch.int64, device=dev)])
    small_words, big_words = -(-emission.k_small // 32), -(-emission.k_big // 32)
    small_slots = n * emission.k_small
    position = torch.arange(pair_src.shape[0], dtype=torch.int64, device=dev)
    real = position < rank_starts[n]
    slot = torch.where(real, pair_src.long(), 0)
    small = slot < small_slots
    t = torch.where(small, slot, slot - small_slots)
    (m_s, s_s), (m_b, s_b) = (slot_divmod_magic(k) for k in (emission.k_small, emission.k_big))
    row = torch.where(small, (t * m_s) >> s_s, (t * m_b) >> s_b)
    col = t - row * torch.where(small, emission.k_small, emission.k_big)
    word = torch.where(small, row * small_words, n * small_words + row * big_words) + (col >> 5)
    record = records[torch.where(real, word, records.shape[0] - 1)]
    place = record[:, 0] + _popcount32(record[:, 1] & ((1 << (col & 31)) - 1))
    perm = torch.empty_like(pair_src)
    return perm.index_put_((torch.where(real, place, position),), position.to(torch.int32))
