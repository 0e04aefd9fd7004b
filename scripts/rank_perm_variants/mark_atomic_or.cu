// A measurement variant of csrc/rank_perm.cu, not built by the package: run it
// beside the package's kernel with
//     python3 scripts/torch_segsum_sweep.py --rank-source scripts/rank_perm_variants/mark_atomic_or.cu
// (the slot-scratch design's C interface: pair_src, pair_gauss, rank_starts,
// scratch, perm, n, num_rows, k_small, k_big, big_rows, stream). Same function
// as the package's.
//
// Design: a kept-cell bitmask marked from pair_src, then one place a pair.
// Each emission row owns ceil(k / 32) 32-bit words (4 MB at 1M splats);
// `mark` reads pair_src coalesced and sets each real pair's bit with an
// integer atomicOr; `place` reads pair_src and pair_gauss coalesced, gathers
// rank_starts[r] and the row's mask word(s), and stores perm[rank_starts[r] +
// popcounts of the bits before the slot] = j. Three scattered accesses a pair
// (the atomicOr, two gathers) besides the scattered store: slower on the H100
// than the slot-scratch design (PERF.md, section 6).

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

// The word that holds a slot's bit, the first word of its row, and the bit.
__device__ __forceinline__ void slot_bit(int slot, const SlotLayout& L, int& first, int& word,
                                         unsigned& bit)
{
    const bool small = slot < L.small_slots;
    const unsigned t = small ? slot : slot - L.small_slots;
    const unsigned row = (unsigned)(((unsigned long long)t * (small ? L.m_small : L.m_big))
                                    >> (small ? L.s_small : L.s_big));
    const unsigned col = t - row * (small ? L.k_small : L.k_big);
    first = small ? row * L.small_words : L.big_word0 + row * L.big_words;
    word = first + (col >> 5);
    bit = col & 31u;
}

extern "C" __global__ void __launch_bounds__(THREADS) rank_perm_mark(
    const int* __restrict__ pair_src, const int* __restrict__ rank_starts,
    unsigned* __restrict__ mask, int n, SlotLayout L)
{
    const int real = rank_starts[n];
    const int j0 = blockIdx.x * (THREADS * ITEMS) + threadIdx.x;
    int slot[ITEMS];
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
        const int j = j0 + u * THREADS;
        slot[u] = j < real ? pair_src[j] : -1;
    }
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
        if (slot[u] < 0) continue;
        int first, word;
        unsigned bit;
        slot_bit(slot[u], L, first, word, bit);
        atomicOr(mask + word, 1u << bit);
    }
}

extern "C" __global__ void __launch_bounds__(THREADS) rank_perm_place(
    const int* __restrict__ pair_src, const int* __restrict__ pair_gauss,
    const int* __restrict__ rank_starts, const unsigned* __restrict__ mask,
    int* __restrict__ perm, int n, int num_rows, SlotLayout L)
{
    const int real = rank_starts[n];
    const int j0 = blockIdx.x * (THREADS * ITEMS) + threadIdx.x;
    int slot[ITEMS], rank[ITEMS];
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
        const int j = j0 + u * THREADS;
        const bool is_real = j < real;
        slot[u] = is_real ? pair_src[j] : -1;
        rank[u] = is_real ? pair_gauss[j] : 0;
    }
    // the gathers of every item before any use: ITEMS of each in flight
    int start[ITEMS], first[ITEMS], word[ITEMS];
    unsigned bit[ITEMS], bits[ITEMS];
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
        if (slot[u] < 0) continue;
        slot_bit(slot[u], L, first[u], word[u], bit[u]);
        start[u] = rank_starts[rank[u]];
        bits[u] = mask[word[u]];
    }
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
        const int j = j0 + u * THREADS;
        if (j >= num_rows) break;
        if (slot[u] < 0) {
            perm[j] = j;  // padding keeps its place
            continue;
        }
        int place = start[u] + __popc(bits[u] & ((1u << bit[u]) - 1u));
        for (int w = first[u]; w < word[u]; ++w) place += __popc(mask[w]);  // k > 32 only
        perm[place] = j;
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

// Launches on `stream`, allocates nothing, does not synchronise. `mask` is
// scratch of n * ceil(k_small / 32) + big_rows * ceil(k_big / 32) words
// (binning.EmissionRows.mask_words), cleared here. Returns the first CUDA
// error (0 = success).
extern "C" int rank_perm_launch(
    const void* pair_src, const void* pair_gauss, const void* rank_starts,
    void* mask, void* perm, int n, int num_rows, int k_small, int k_big,
    int big_rows, void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    if (num_rows <= 0) return (int)cudaGetLastError();
    SlotLayout L;
    L.k_small = k_small > 0 ? k_small : 1;
    L.k_big = k_big > 0 ? k_big : 1;
    L.small_words = (L.k_small + 31) / 32;
    L.big_words = (L.k_big + 31) / 32;
    L.small_slots = n * L.k_small;
    L.big_word0 = n * L.small_words;
    divmod_magic(L.k_small, &L.m_small, &L.s_small);
    divmod_magic(L.k_big, &L.m_big, &L.s_big);
    const size_t words = (size_t)L.big_word0 + (size_t)big_rows * L.big_words;
    if (words > 0) {
        cudaError_t err = cudaMemsetAsync(mask, 0, words * sizeof(unsigned), st);
        if (err != cudaSuccess) return (int)err;
    }
    const int blocks = (num_rows + THREADS * ITEMS - 1) / (THREADS * ITEMS);
    rank_perm_mark<<<blocks, THREADS, 0, st>>>(
        (const int*)pair_src, (const int*)rank_starts, (unsigned*)mask, n, L);
    rank_perm_place<<<blocks, THREADS, 0, st>>>(
        (const int*)pair_src, (const int*)pair_gauss, (const int*)rank_starts,
        (const unsigned*)mask, (int*)perm, n, num_rows, L);
    return (int)cudaGetLastError();
}
