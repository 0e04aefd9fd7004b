"""The backward's per-splat reduction on the CPU: the rank permutation that
the rank_perm kernel's rule (its plain version `binning.rank_permutation_by_mask`,
through the wrapper on CPU tensors) reads from binning's own sort and kept
cells, the segment sum on ragged segments,
the segsum kernel's owner rule through its plain mirror
(`tile_raster.segsum_runs`), and the explicit backward through both against `jax.grad` of the JAX
`jnp_tile` backend (atol 5e-6 / rtol 3e-3, the reference suite's gradient tolerance,
tests/test_pallas.py:60-64).

The binning inputs are JAX's projection of numpy-seeded scenes, the cases of
tests/test_torch_binning.py."""

import pathlib
import re

import hypothesis
import hypothesis.strategies as st
import jax  # noqa: F401  (the binning cases start from JAX's projection)
import numpy as np
import pytest
import torch
from test_torch_binning import CASES, _jax_projection, _to_torch
from test_torch_raster_bwd import _assert_grads_close, _jax_grads, _torch_grads

from gaussian_splat_tpu_torch.config import RenderConfig
from gaussian_splat_tpu_torch.ops import binning, cuda_raster, tile_raster


def _binning(case):
    c = CASES[case] if case in CASES else dict(seed=6, n=120, cfg={}, scale_range=(0.02, 0.2))
    proj, op = _jax_projection(
        c["seed"], c["n"], 96, 64, c.get("scale_range", (0.02, 0.1)), c.get("eye", (0, 0, -4))
    )
    cfg = RenderConfig(**c["cfg"])
    opacities = None if case == "no-cell-test" else torch.from_numpy(np.array(op))
    return binning.bin_gaussians(_to_torch(proj), 96, 64, cfg, opacities=opacities), cfg


@pytest.mark.parametrize("case", [*CASES, "no-cell-test"])
def test_permutation_from_binning_equals_the_rank_sort(case):
    b, cfg = _binning(case)
    n = b.rank_starts.shape[0] - 1
    want = tile_raster.rank_permutation(b.pair_gauss, b.rank_starts, n)
    # the rank_perm kernel's rule on binning's kept cells, through its plain version
    got = cuda_raster.rank_permutation_from_sort(b.pair_src, b.rank_starts, b.kept, cfg)
    assert b.pair_src.dtype == got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)
    real = int(b.rank_starts[-1])
    # the padding tail keeps its places
    assert torch.equal(got[real:], torch.arange(real, got.shape[0], dtype=torch.int32))


@hypothesis.settings(max_examples=120, deadline=None, derandomize=True)
@hypothesis.given(
    n=st.integers(0, 40),
    k_small=st.integers(1, 8),
    k_big=st.integers(1, 70),  # past 32 and 64: a row of several bitmask words
    capacity=st.integers(1, 12),
    padding=st.integers(0, 6),
    seed=st.integers(0, 2**16),
)
@hypothesis.example(n=0, k_small=6, k_big=32, capacity=4, padding=5, seed=0)  # no real pair
@hypothesis.example(n=30, k_small=33, k_big=70, capacity=12, padding=3, seed=3)  # 2 and 3 words
def test_permutation_from_sort_on_synthetic_emission(n, k_small, k_big, capacity, padding, seed):
    """Any emission that keeps binning's layout — N rows of k_small slots, then
    big_capacity(N) rows of k_big, each row's kept cells on rising tiles, the
    big ranks' small rows and the spare big rows empty — sorted by
    (tile, rank) as binning sorts it: the permutation the rank_perm kernel's
    bitmask rule (its plain version `binning.rank_permutation_by_mask`)
    rebuilds from the sort's indices and the kept cells equals the stable
    rank sort, on rows of one word and of several, empty rows, padding and
    no real pair."""
    rng = np.random.default_rng(seed)
    cfg = RenderConfig(small_tiles_per_gaussian=k_small, max_tiles_per_gaussian=k_big,
                       big_tier_capacity=capacity)
    m_big = cfg.big_capacity(n)
    big = np.sort(rng.choice(n, size=int(rng.integers(0, m_big + 1)), replace=False))
    sentinel = 1 << 40
    keys, ranks, kept_rows = [], [], ([], [])
    big_ranks = [*big, *[-1] * (m_big - len(big))]  # spare rows: no kept cell, any rank
    tiers = ((False, k_small, range(n)), (True, k_big, big_ranks))
    for big_tier, width, row_ranks in tiers:
        for r in row_ranks:
            on = r >= 0 and big_tier == (r in big)
            kept = on & (rng.random(width) < rng.random())
            tiles = np.cumsum(rng.integers(1, 4, width))  # rising along the row
            keys += [(int(t) << 32) | int(r) if k else sentinel for t, k in zip(tiles, kept)]
            ranks += [int(r) if k else 0 for k in kept]
            kept_rows[big_tier].append(kept)
    keys, ranks = torch.tensor(keys, dtype=torch.int64), torch.tensor(ranks, dtype=torch.int32)
    real = int((keys < sentinel).sum())
    budget = min(real + padding, keys.shape[0])
    sorted_keys, src = torch.sort(keys)
    pair_gauss = torch.where(sorted_keys < sentinel, sorted_keys & 0xFFFFFFFF, 0)[:budget]
    counts = torch.bincount(pair_gauss[:real].long(), minlength=n)
    rank_starts = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(counts, 0)])

    small, big_cells = (torch.tensor(np.array(rows, bool).reshape(-1, k))
                        for rows, k in zip(kept_rows, (k_small, k_big)))
    kept = binning.KeptCells(small, big_cells, torch.tensor(big_ranks, dtype=torch.int32))
    got = cuda_raster.rank_permutation_from_sort(src[:budget].int(), rank_starts.int(), kept, cfg)
    assert got.dtype == torch.int32
    assert torch.equal(got, tile_raster.rank_permutation(pair_gauss.int(), rank_starts.int(), n))
    # the padding tail keeps its places
    assert torch.equal(got[real:], torch.arange(real, budget, dtype=torch.int32))


def test_slot_divmod_magic():
    """The rank_perm kernel's divide-free row of a slot: x // d == (x * m) >> s
    for every divisor a row width can take and dividends on both sides of
    every multiple, up to 2**31 − 1; m fits 32 bits, x * m 63."""
    rng = np.random.default_rng(0)
    for d in [*range(1, 300), 1023, 1024, 1025, 65537, 2**20 + 7, 2**30 + 1, 2**31 - 1]:
        m, s = binning.slot_divmod_magic(d)
        assert 0 < m < 2**32 and s < 64
        q = rng.integers(0, (2**31 - 1) // d + 1, 200)
        x = np.concatenate([q * d, q * d - 1, q * d + d - 1, rng.integers(0, 2**31, 200),
                            [0, 1, d - 1, d, 2**31 - 1]])
        x = [int(v) for v in x if 0 <= v < 2**31]
        assert [(v * m) >> s for v in x] == [v // d for v in x], d
        assert (2**31 - 1) * m < 2**63


@hypothesis.settings(max_examples=100, deadline=None, derandomize=True)
@hypothesis.given(
    lengths=st.lists(  # ragged: many empty ranks, segments past 32
        st.one_of(st.just(0), st.integers(0, 4), st.integers(20, 70)), min_size=0, max_size=60
    ),
    padding=st.integers(0, 5),
    seed=st.integers(0, 2**16),
)
def test_segment_sum_of_ragged_segments(lengths, padding, seed):
    """The segment sum on ragged segments (empty ranks, long segments, no real
    pair at all, junk in the padding rows) against a numpy loop in position
    order — the order in which the kernel adds; empty ranks sum to zero."""
    n = len(lengths)
    lengths = np.asarray(lengths, np.int64)
    rank_starts = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    num_rows = int(rank_starts[-1]) + padding
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_rows).astype(np.int32)
    rows = rng.standard_normal((num_rows, 12)).astype(np.float32)
    want = np.zeros((n, 12), np.float32)
    for r in range(n):
        for p in range(rank_starts[r], rank_starts[r + 1]):
            want[r] += rows[perm[p]]
    got = cuda_raster.segment_sum(
        torch.from_numpy(rows), torch.from_numpy(perm), torch.from_numpy(rank_starts), n
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not got[lengths == 0].any()


def test_segsum_run_places_is_the_kernels():
    """The mirror's run length is the kernel's ITEMS."""
    src = (pathlib.Path(tile_raster.__file__).parents[1] / "csrc" / "segsum.cu").read_text()
    assert re.search(r"#define ITEMS (\d+)", src).group(1) == str(tile_raster.SEGSUM_RUN_PLACES)


@hypothesis.settings(max_examples=150, deadline=None, derandomize=True)
@hypothesis.given(
    lengths=st.lists(  # empty ranks, short segments, segments past a run
        st.one_of(st.just(0), st.integers(0, 4), st.integers(20, 90)), min_size=0, max_size=80
    ),
    places=st.sampled_from([4, 8, 32, tile_raster.SEGSUM_RUN_PLACES]),
    padding=st.integers(0, 40),
    seed=st.integers(0, 2**16),
)
def test_segsum_owner_rule(lengths, places, padding, seed):
    """The segsum kernel's owner rule (`tile_raster.segsum_runs`): over the
    launch's warp runs every rank is owned exactly once, in order, the warps'
    positions follow one another without a gap or an overlap, a warp owns
    ranks whose places lie in its run only, and summing each warp's positions
    into its own ranks gives what a numpy loop gives. Runs shorter than
    segments, n not a multiple of the run, no real pair at all."""
    n = len(lengths)
    lengths = np.asarray(lengths, np.int64)
    rank_starts = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    total = int(rank_starts[-1])
    num_rows = total + padding
    runs = tile_raster.segsum_runs(torch.from_numpy(rank_starts), n, num_rows, places).numpy()
    assert runs.shape == (-(-(n + num_rows) // places), 4)
    first, owned, p_lo, p_hi = runs.T
    assert np.array_equal(np.concatenate([np.arange(f, f + o) for f, o in runs[:, :2]] or [[]]),
                          np.arange(n))
    if len(runs):  # n = 0 and B = 0: no warp at all
        assert p_lo[0] == 0 and p_hi[-1] == total and np.array_equal(p_lo[1:], p_hi[:-1])
    assert owned.max(initial=0) <= places
    for w, (f, o, lo, hi) in enumerate(runs):
        r = np.arange(f, f + o)
        place = r + rank_starts[r]
        assert ((place >= w * places) & (place < (w + 1) * places)).all()
        assert lo == rank_starts[f] and hi == rank_starts[f + o]

    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_rows).astype(np.int32)
    rows = rng.standard_normal((num_rows, 12)).astype(np.float32)
    want = np.zeros((n, 12), np.float64)
    for r in range(n):
        for p in range(rank_starts[r], rank_starts[r + 1]):
            want[r] += rows[perm[p]]
    got = np.full((n, 12), np.nan)
    for f, o, lo, hi in runs:
        starts = rank_starts[f : f + o + 1]
        got[f : f + o] = 0.0  # owned ranks with no pair stay zero
        for p in range(lo, hi):
            got[f + np.searchsorted(starts, p, side="right") - 1] += rows[perm[p]]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind,seed,width,height", [("random", 0, 96, 64), ("deep", 5, 64, 64)])
def test_explicit_backward_takes_the_permutation_from_binning(kind, seed, width, height, monkeypatch):
    """The explicit backward on CPU tensors sorts no pair: it reads the rank
    order from binning (once per backward, equal to the rank sort) and its
    gradients match `jax.grad` of jnp_tile."""
    real_sort = tile_raster.rank_permutation
    real_backward = cuda_raster.raster_backward
    pair_lists, built = [], []

    def no_sort(*a, **k):
        raise AssertionError("the backward sorted the pairs again")

    def raster_backward(table, pair_gauss, *a, **k):  # keeps the pair list for the check
        pair_lists.append(pair_gauss)
        return real_backward(table, pair_gauss, *a, **k)

    def from_sort(pair_src, rank_starts, kept, config):
        perm = binning.rank_permutation_by_mask(pair_src, rank_starts, kept, config)
        built.append(torch.equal(
            perm, real_sort(pair_lists[-1], rank_starts, rank_starts.shape[0] - 1)))
        return perm

    monkeypatch.setattr(tile_raster, "rank_permutation", no_sort)
    monkeypatch.setattr(cuda_raster, "raster_backward", raster_backward)
    monkeypatch.setattr(cuda_raster, "rank_permutation_from_sort", from_sort)
    got = _torch_grads(True, kind, seed, width, height)
    assert built == [True]
    _assert_grads_close(got, _jax_grads("jnp_tile", kind, seed, width, height), "jnp_tile")
