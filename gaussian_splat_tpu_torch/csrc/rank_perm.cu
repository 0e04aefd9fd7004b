// rank_perm — the pair list's rank order, read from binning's own sort, for
// Hopper (sm_90a), plain C interface.
//
// Takes the place of the second sort that the TPU backward runs before its
// segment sum (gaussian_splat_tpu/ops/pallas_raster.py::_gather_pairs_t_bwd,
// a lax.sort of the pairs by depth rank; no pallas_call). The function:
//     perm[rank_starts[r] + w] = j   for each real pair j (j < rank_starts[N])
//     perm[j] = j                    for each padding pair
// where r is the pair's depth rank and w the number of kept cells of its
// emission row before its own slot pair_src[j]. The emission slots are N rows
// of k_small cells (row r = rank r), then big_rows rows of k_big (the big
// tier, row b of rank big_ranks[b]); a row emits its rect's cells in
// row-major order, so a splat's pairs sit in the tile-major pair list in the
// order of their slots and `perm` is exactly the stable sort of the pair list
// by rank (tile_raster.rank_permutation). binning.rank_permutation_from_sort
// is the plain version, binning.rank_permutation_by_mask the plain mirror of
// the rule below.
//
// Design: a kept-cell bitmask of ceil(k / 32) 32-bit words a row, each word
// with its place, then one place a pair. Which cells are kept, binning
// decided before its sort (BinningResult.kept, one byte a slot), so nothing
// marks them again. `pack` (a thread a row, coalesced) turns each row's kept
// cells into words and writes a record a word, (place of the word's first
// kept cell, bits): 8 bytes a row at the defaults, 8.25 MB at 1M splats,
// which stays in the 50 MB L2; it also zeroes perm (padding: perm[j] = j).
// `place` (a thread ITEMS pairs, pair_src read coalesced) finds each pair's
// row and column with a multiply by a magic constant (x / d == (x * m) >> s
// for x < 2^31, no divide), gathers its word's record and adds j into
// perm[record.place + popcount of the bits below its column] with an integer
// atomicAdd: every place has one pair, so the sum onto 0 is exact and the
// result the same from run to run. Two device operations a call.
//
// Bound on this card: bytes (pair_src, the kept bytes, rank_starts read,
// perm written once). What it costs instead are the two scattered accesses a
// pair: one 8-byte record gather from L2 and one 4-byte reduction into perm;
// on the H100 a scattered 4-byte reduction of 2.46M pairs takes ~30 us, a
// plain scattered store ~40 us, an L2 gather ~15 us (PERF.md, section 6).

#include <cuda_runtime.h>

#define THREADS 256
#define ITEMS 4  // pairs a thread, THREADS apart: ITEMS loads in flight, coalesced

struct SlotLayout {
    int small_slots;  // n * k_small: the slots of the small rows
    int big_word0;    // n * small_words: the first big row's first word
    int k_small, k_big, small_words, big_words;
    unsigned m_small, m_big;  // row = (slot * m) >> s within a tier
    int s_small, s_big;
};

// The word that holds a slot's bit, and the bit.
__device__ __forceinline__ void slot_bit(int slot, const SlotLayout& L, int& word,
                                         unsigned& bit)
{
    const bool small = slot < L.small_slots;
    const unsigned t = small ? slot : slot - L.small_slots;
    const unsigned row = (unsigned)(((unsigned long long)t * (small ? L.m_small : L.m_big))
                                    >> (small ? L.s_small : L.s_big));
    const unsigned col = t - row * (small ? L.k_small : L.k_big);
    word = (small ? row * L.small_words : L.big_word0 + row * L.big_words) + (col >> 5);
    bit = col & 31u;
}

// Thread t: row t's records (t < n + big_rows) and perm[t] (t < num_rows).
extern "C" __global__ void __launch_bounds__(THREADS) rank_perm_pack(
    const unsigned char* __restrict__ kept_small, const unsigned char* __restrict__ kept_big,
    const int* __restrict__ big_ranks, const int* __restrict__ rank_starts,
    int2* __restrict__ records, int* __restrict__ perm, int n, int big_rows, int num_rows,
    SlotLayout L)
{
    const int t = blockIdx.x * THREADS + threadIdx.x;
    if (t < num_rows) perm[t] = t < rank_starts[n] ? 0 : t;  // 0 under each place's one add
    if (t >= n + big_rows) return;
    const bool small = t < n;
    const int k = small ? L.k_small : L.k_big;
    const unsigned char* cells =
        small ? kept_small + (long long)t * k : kept_big + (long long)(t - n) * k;
    int2* rec = records + (small ? t * L.small_words : L.big_word0 + (t - n) * L.big_words);
    int start = -1, before = 0;  // the row's rank start, its kept cells so far
    for (int c0 = 0; c0 < k; c0 += 32) {
        const int width = k - c0 < 32 ? k - c0 : 32;
        unsigned bits = 0;
        for (int c = 0; c < width; ++c) bits |= (unsigned)(cells[c0 + c] != 0) << c;
        // a row with no kept cell is read by no pair (its rank may be any index)
        if (bits && start < 0) start = rank_starts[small ? t : big_ranks[t - n]];
        rec[c0 >> 5] = make_int2((start < 0 ? 0 : start) + before, (int)bits);
        before += __popc(bits);
    }
}

extern "C" __global__ void __launch_bounds__(THREADS) rank_perm_place(
    const int* __restrict__ pair_src, const int* __restrict__ rank_starts,
    const int2* __restrict__ records, int* __restrict__ perm, int n, SlotLayout L)
{
    const int real = rank_starts[n];
    const int j0 = blockIdx.x * (THREADS * ITEMS) + threadIdx.x;
    int slot[ITEMS];
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
        const int j = j0 + u * THREADS;
        slot[u] = j < real ? pair_src[j] : -1;
    }
    // the gathers of every item before any use: ITEMS in flight
    int2 rec[ITEMS];
    unsigned bit[ITEMS];
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
        if (slot[u] < 0) continue;
        int word;
        slot_bit(slot[u], L, word, bit[u]);
        rec[u] = records[word];
    }
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
        if (slot[u] < 0) continue;
        atomicAdd(perm + rec[u].x + __popc((unsigned)rec[u].y & ((1u << bit[u]) - 1u)),
                  j0 + u * THREADS);
    }
}

// x / d == (x * m) >> s for every 0 <= x < 2^31, d >= 1: s = 31 + ceil(log2 d),
// m = ceil(2^s / d) < 2^32 (binning.slot_divmod_magic is the same rule).
static void divmod_magic(int d, unsigned* m, int* s)
{
    int l = 0;
    while ((1u << l) < (unsigned)d) ++l;
    *s = 31 + l;
    *m = (unsigned)(((1ull << *s) + (unsigned)d - 1) / (unsigned)d);
}

// Launches on `stream`, allocates nothing, does not synchronise. `kept_small`
// (n, k_small) and `kept_big` (big_rows, k_big) are bool bytes, `big_ranks`
// (big_rows,) int32; `records` is scratch of n * ceil(k_small / 32) +
// big_rows * ceil(k_big / 32) int2 (binning.EmissionRows.mask_words).
// Returns the first CUDA error (0 = success).
extern "C" int rank_perm_launch(
    const void* pair_src, const void* kept_small, const void* kept_big, const void* big_ranks,
    const void* rank_starts, void* records, void* perm, int n, int num_rows, int k_small,
    int k_big, int big_rows, void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    SlotLayout L;
    L.k_small = k_small > 0 ? k_small : 1;
    L.k_big = k_big > 0 ? k_big : 1;
    L.small_words = (L.k_small + 31) / 32;
    L.big_words = (L.k_big + 31) / 32;
    L.small_slots = n * L.k_small;
    L.big_word0 = n * L.small_words;
    divmod_magic(L.k_small, &L.m_small, &L.s_small);
    divmod_magic(L.k_big, &L.m_big, &L.s_big);
    const int threads = n + big_rows > num_rows ? n + big_rows : num_rows;
    if (threads > 0)
        rank_perm_pack<<<(threads + THREADS - 1) / THREADS, THREADS, 0, st>>>(
            (const unsigned char*)kept_small, (const unsigned char*)kept_big,
            (const int*)big_ranks, (const int*)rank_starts, (int2*)records, (int*)perm, n,
            big_rows, num_rows, L);
    if (num_rows > 0)
        rank_perm_place<<<(num_rows + THREADS * ITEMS - 1) / (THREADS * ITEMS), THREADS, 0, st>>>(
            (const int*)pair_src, (const int*)rank_starts, (const int2*)records, (int*)perm, n, L);
    return (int)cudaGetLastError();
}
