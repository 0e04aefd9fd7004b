"""Plain mirrors of the binning kernels' rules (csrc/binning.cu), kept here
because only these tests run them, held on the CPU to the plain version's
sorts (the card tests, tests/test_torch_binning_cuda.py, hold the kernels
themselves to the plain version bit for bit):

  * `big_tier_by_histogram` (bin_rects: the big tier from a histogram of the
    areas and a prefix count of the ties) against `_top_indices`, on
    tie-heavy and overflowing inputs and on a projected scene;
  * `big_rows_by_partition` (bin_count: the rank-space big rows as a stable
    partition by a scan) against `_top_indices(is_big)`;
  * `pairs_by_count` (bin_count, bin_offsets, bin_scatter: the pair list by
    count, column scan and stable scatter) against the sort of padded keys
    that `bin_gaussians_torch` runs;
  * `bin_gaussians` on CPU tensors is the plain version, with pair_src 0 on
    padding rows.
"""

import numpy as np
import pytest
import torch

from gaussian_splat_tpu_torch import Camera, GaussianModel, RenderConfig
from gaussian_splat_tpu_torch.ops import binning, cuda_raster
from gaussian_splat_tpu_torch.ops.projection import project_gaussians


def big_tier_by_histogram(area: torch.Tensor, k_small: int, m_big: int) -> torch.Tensor:
    """(N,) bool, the big tier as bin_rects decides it with no sort (the
    plain mirror of its rule); `area` (N,) int: the K-capped rect areas, 0 on
    invalid rows. Every eligible splat (area > k_small) if at most m_big
    are; else those above a*, the largest area with at least m_big eligible
    splats at or above it, and at a* the lowest indices while the tier has
    room: `_top_indices`' m_big largest eligible areas, ties to the lower
    index."""
    eligible = area > k_small
    if int(eligible.sum()) <= m_big:
        return eligible
    bins = torch.bincount(area[eligible].long(), minlength=int(area.max()) + 2)
    at_or_above = bins.flip(0).cumsum(0).flip(0)
    astar = int((at_or_above >= m_big).nonzero().max())
    room = m_big - int(at_or_above[astar + 1])
    ties = area == astar
    return (area > astar) | (ties & (torch.cumsum(ties, 0) <= room))


def big_rows_by_partition(is_big: torch.Tensor, m_big: int) -> torch.Tensor:
    """(m_big,) int32, the big rows' ranks as bin_count places them (the
    plain mirror of its rule); `is_big` (N,) bool in rank order, at most
    m_big set. A big rank owns row (big ranks before it); a non-big rank with
    q non-big ranks before it owns row nb + q while that is below m_big: a
    stable partition by a scan, `_top_indices(is_big, m_big)`."""
    ranks = torch.arange(is_big.shape[0], device=is_big.device)
    big_before = torch.cumsum(is_big, 0) - is_big.long()
    row = torch.where(is_big, big_before, int(is_big.sum()) + ranks - big_before)
    owned = row < m_big
    rows = torch.empty((m_big,), dtype=torch.int32, device=is_big.device)
    rows[row[owned]] = ranks[owned].to(torch.int32)
    return rows


def pairs_by_count(tiles_small: torch.Tensor, tiles_big: torch.Tensor, kept: binning.KeptCells,
                   budget: int, num_tiles: int, ranks_per_block: int = 2048):
    """(pair_gauss, pair_tile, pair_src, tile_offsets, tile_counts), the pair
    list as bin_count, bin_offsets and bin_scatter build it (the plain mirror
    of their rules). `kept`: the kept, in-budget cells of the emission rows
    (`BinningResult.kept`); `tiles_small` (M, k_small) and `tiles_big`
    (big, k_big): each slot's tile id.
    The kept cells in rank-major order (a rank's cells in slot order); each
    block of ranks_per_block ranks counts its cells by tile; a column scan
    over the blocks gives each block's base in each tile, past the tile's
    offset; then each block places its cells in that order, each at its
    tile's counter."""
    m, k_small = kept.small.shape
    k_big = kept.big.shape[1]
    rows_rank = torch.cat([torch.arange(m), kept.big_ranks.long()])
    slot0 = torch.cat([torch.arange(m) * k_small, m * k_small + torch.arange(
        kept.big.shape[0]) * k_big])
    cells = []
    for mask, tile, first in ((kept.small, tiles_small, 0), (kept.big, tiles_big, m)):
        row, col = mask.nonzero(as_tuple=True)
        cells.append(torch.stack([rows_rank[first + row], slot0[first + row] + col,
                                  tile[row, col].long()]))
    rank, slot, tile = torch.cat(cells, 1)
    # rank-major: a rank's cells come from one row, in slot order
    by_rank = torch.argsort(rank * (slot.max() + 1) + slot)
    rank, slot, tile = rank[by_rank], slot[by_rank], tile[by_rank]
    block = rank // ranks_per_block
    blocks = int(block.max()) + 1 if rank.numel() else 0
    hist = torch.zeros((blocks, num_tiles), dtype=torch.long)
    hist.index_put_((block, tile), torch.ones_like(tile), accumulate=True)
    tile_counts = hist.sum(0)
    tile_offsets = torch.cumsum(tile_counts, 0) - tile_counts
    counter = (tile_offsets + torch.cumsum(hist, 0) - hist).tolist()
    pair_gauss = torch.zeros((budget,), dtype=torch.int32)
    pair_tile = torch.full((budget,), num_tiles, dtype=torch.int32)
    pair_src = torch.zeros((budget,), dtype=torch.int32)
    for r, s, b, t in zip(rank.tolist(), slot.tolist(), block.tolist(), tile.tolist()):
        pos = counter[b][t]
        counter[b][t] += 1
        pair_gauss[pos], pair_tile[pos], pair_src[pos] = r, t, s
    return (pair_gauss, pair_tile, pair_src, tile_offsets.to(torch.int32),
            tile_counts.to(torch.int32))


def _tier_by_sort(area, k_small, m_big):
    eligible = area > k_small
    idx = binning._top_indices(torch.where(eligible, area, 0), m_big)
    is_big = torch.zeros_like(eligible)
    is_big[idx] = eligible[idx]
    return is_big


@pytest.mark.parametrize("case", ["ties_overflow", "no_overflow", "all_tied", "random"])
def test_big_tier_by_histogram_is_top_indices(case):
    rng = np.random.RandomState({"ties_overflow": 0, "no_overflow": 1, "all_tied": 2,
                                 "random": 3}[case])
    for _ in range(40):
        n, k_small, k_big = rng.randint(1, 400), 6, 32
        if case == "ties_overflow":  # few distinct areas: every cut falls inside a tie
            area = rng.choice([0, 3, 7, 9, 32], size=n)
            m_big = rng.randint(1, max(2, n // 3))
        elif case == "no_overflow":
            area = rng.randint(0, k_big + 1, size=n)
            m_big = max(1, int((area > k_small).sum())) + rng.randint(0, 5)
        elif case == "all_tied":
            area = np.full(n, 12)
            m_big = rng.randint(1, n + 1)
        else:
            area = rng.randint(0, k_big + 1, size=n) * (rng.rand(n) < 0.6)
            m_big = rng.randint(1, n + 1)
        area = torch.as_tensor(area, dtype=torch.int32)
        got = big_tier_by_histogram(area, k_small, m_big)
        assert torch.equal(got, _tier_by_sort(area, k_small, m_big))
        assert int(got.sum()) == min(int((area > k_small).sum()), m_big)


def _scene(n=3000, seed=0, width=160, height=96):
    gen = torch.Generator().manual_seed(seed)
    model = GaussianModel.random(gen, n, sh_degree=0, extent=1.2, scale_range=(0.01, 0.4),
                                 device="cpu")
    cam = Camera.from_lookat((0, 0, -3), (0, 0, 0), (0, 1, 0), 60.0, width, height,
                             device="cpu")
    op = torch.sigmoid(model.opacity_logits.detach())
    proj = project_gaussians(model.means.detach(), model.quats.detach(),
                             torch.exp(model.log_scales.detach()), cam, opacities=op,
                             alpha_skip=1.0 / 255.0)
    return proj, op, cam


def test_big_tier_by_histogram_on_a_projected_scene():
    """The tier of effective_rects (by sort) against the mirror's, with the
    capacity at, below and far below the eligible count."""
    proj, _, cam = _scene()
    cfg = RenderConfig(max_tiles_per_gaussian=16, small_tiles_per_gaussian=2)
    _, _, w, h, _ = binning.tile_rects(proj.means2d, proj.radii, proj.valid, cam.width,
                                       cam.height, cfg, extents=proj.extents)
    area = w * h
    eligible = int((area > 2).sum())
    assert eligible > 40
    for cap in (eligible, eligible - 1, eligible // 7):
        c = RenderConfig(max_tiles_per_gaussian=16, small_tiles_per_gaussian=2,
                         big_tier_capacity=cap)
        is_big = binning.effective_rects(proj.means2d, proj.radii, proj.valid, cam.width,
                                         cam.height, c, extents=proj.extents)[4]
        assert torch.equal(big_tier_by_histogram(area, 2, c.big_capacity(area.numel())),
                           is_big)


@pytest.mark.parametrize("share", [0.0, 0.3, 1.0])
def test_big_rows_by_partition_is_top_indices(share):
    rng = np.random.RandomState(int(share * 10))
    for _ in range(40):
        n = rng.randint(1, 500)
        m_big = rng.randint(1, n + 1)
        is_big = torch.as_tensor(rng.rand(n) < share)
        # at most m_big big ranks, as the tier guarantees
        is_big &= torch.cumsum(is_big, 0) <= m_big
        got = big_rows_by_partition(is_big, m_big)
        want = binning._top_indices(is_big.to(torch.int32), m_big).to(torch.int32)
        assert torch.equal(got, want)


def _emission(rng, m, m_big, k_small, k_big, tx_n, ty_n):
    """Random emission rows as bin_gaussians lays them out: each rank's rect
    inside the grid, a big tier of at most m_big ranks with their rows
    (`big_rows_by_partition`), random kept cells among each rect's."""
    is_big = torch.as_tensor(rng.rand(m) < 0.2)
    is_big &= torch.cumsum(is_big, 0) <= m_big
    big_ranks = big_rows_by_partition(is_big, m_big)

    def rows(ranks, k, big):
        tiles = torch.zeros((len(ranks), k), dtype=torch.int32)
        kept = torch.zeros((len(ranks), k), dtype=torch.bool)
        for i, r in enumerate(ranks.tolist()):
            if bool(is_big[r]) != big:
                continue
            w = rng.randint(1, min(k, tx_n) + 1)
            h = rng.randint(0, min(k // w, ty_n) + 1)
            x0, y0 = rng.randint(0, tx_n - w + 1), rng.randint(0, ty_n - h + 1)
            c = np.arange(w * h)
            tiles[i, : w * h] = torch.as_tensor((y0 + c // w) * tx_n + x0 + c % w)
            kept[i, : w * h] = torch.as_tensor(rng.rand(w * h) < 0.7)
        return tiles, kept

    tiles_small, kept_small = rows(torch.arange(m), k_small, False)
    tiles_big, kept_big = rows(big_ranks.long(), k_big, True)
    return tiles_small, tiles_big, binning.KeptCells(kept_small, kept_big, big_ranks)


def _pairs_by_sort(tiles_small, tiles_big, kept, budget, num_tiles):
    """Step 3 and 4 of bin_gaussians_torch: padded keys, one sort."""
    m = tiles_small.shape[0]
    sentinel = num_tiles << 32

    def keys(tiles, ok, ranks):
        key = (tiles.long() << 32) | ranks[:, None].long()
        return torch.where(ok, key, sentinel).reshape(-1)

    flat = torch.cat([keys(tiles_small, kept.small, torch.arange(m)),
                      keys(tiles_big, kept.big, kept.big_ranks)])
    sorted_keys, src = torch.sort(flat)
    sorted_keys = sorted_keys[:budget]
    pair_tile = (sorted_keys >> 32).to(torch.int32)
    pair_gauss = torch.where(pair_tile < num_tiles, (sorted_keys & 0xFFFFFFFF).to(torch.int32), 0)
    bounds = torch.searchsorted(pair_tile, torch.arange(num_tiles + 1, dtype=torch.int32))
    return (pair_gauss, pair_tile,
            torch.where(pair_tile < num_tiles, src[:budget].to(torch.int32), 0),
            bounds[:-1].to(torch.int32), (bounds[1:] - bounds[:-1]).to(torch.int32))


@pytest.mark.parametrize("case", ["one_block", "many_blocks", "budget_cut"])
def test_pairs_by_count_is_the_sort_of_padded_keys(case):
    rng = np.random.RandomState(len(case))
    m, m_big, k_small, k_big, tx_n, ty_n = 700, 90, 6, 40, 9, 7
    tiles_small, tiles_big, kept = _emission(rng, m, m_big, k_small, k_big, tx_n, ty_n)
    counts = kept.small.sum(1).long()
    counts.index_add_(0, kept.big_ranks.long(), kept.big.sum(1).long())
    total = int(counts.sum())
    budget = total + 37
    if case == "budget_cut":  # the ranks past the budget emit nothing
        budget = total * 2 // 3
        fits = torch.cumsum(counts, 0) <= budget
        kept = binning.KeptCells(kept.small & fits[:, None],
                                 kept.big & fits[kept.big_ranks.long()][:, None],
                                 kept.big_ranks)
    block = {"one_block": 2048, "many_blocks": 64, "budget_cut": 100}[case]
    got = pairs_by_count(tiles_small, tiles_big, kept, budget, tx_n * ty_n, block)
    want = _pairs_by_sort(tiles_small, tiles_big, kept, budget, tx_n * ty_n)
    for name, g, w in zip(("pair_gauss", "pair_tile", "pair_src", "tile_offsets",
                           "tile_counts"), got, want):
        assert torch.equal(g, w), name


def test_bin_gaussians_on_cpu_is_the_plain_version():
    """CPU tensors take the plain version and launch nothing; its pair_src
    is 0 on every padding row."""
    proj, op, cam = _scene(seed=1)
    cfg = RenderConfig()
    cuda_raster.reset_launch_counts()
    got = binning.bin_gaussians(proj, cam.width, cam.height, cfg, opacities=op)
    want = binning.bin_gaussians_torch(proj, cam.width, cam.height, cfg, opacities=op)
    assert cuda_raster.launch_counts == dict.fromkeys(cuda_raster.KERNELS, 0)
    for name in binning.BinningResult._fields:
        if name != "kept":
            assert torch.equal(getattr(got, name), getattr(want, name)), name
    padding = got.pair_tile == cfg.num_tiles(cam.width, cam.height)
    assert int(padding.sum()) > 0 and not got.pair_src[padding].any()
    assert int((~padding).sum()) == int(got.rank_starts[-1])
