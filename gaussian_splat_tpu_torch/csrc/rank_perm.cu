// rank_perm — the pair list's rank order, read from binning's own sort, for
// Hopper (sm_90a), plain C interface.
//
// Takes the place of the second sort that the TPU backward runs before its
// segment sum (gaussian_splat_tpu/ops/pallas_raster.py::_gather_pairs_t_bwd,
// a lax.sort of the pairs by depth rank; no pallas_call). The function:
//     perm[rank_starts[r] + w] = j   for each real pair j (j < rank_starts[N])
//     perm[j] = j                    for each padding pair
// where r = pair_gauss[j] is the pair's depth rank and w the number of kept
// cells of its emission row before its own slot pair_src[j]. The emission
// slots are N rows of k_small cells (row r = rank r), then big_rows rows of
// k_big; a row emits its rect's cells in row-major order, so a splat's pairs
// sit in the tile-major pair list in the order of their slots and `perm` is
// exactly the stable sort of the pair list by rank
// (tile_raster.rank_permutation); binning.rank_permutation_from_sort is the
// plain version.
//
// Design: the inverse of the sort's indices, then a walk of the emission
// rows. `scatter` writes, for each real pair j, inv[pair_src[j]] = j into a
// scratch of one int per emission slot (28 MB at 1M splats, cleared to -1
// first), and perm[j] = j for each padding pair. `rows` gives each row a
// thread that reads the row's slots in order, CHUNK at a time (neighbouring
// threads, neighbouring rows: coalesced) and writes each kept slot's pair to the next
// place of its rank, rank_starts[r], rank_starts[r] + 1, ... (neighbouring
// ranks, neighbouring places). The only scattered access is the one 4-byte
// write a pair of the inverse; there are no atomics, and every write has
// one writer, so the result is the same from run to run. Bound on this
// card: bytes — 8 B of pair_src and pair_gauss a real pair, 4 B of perm a
// pair, rank_starts once; the scratch (cleared, written, read once) moves
// about as much again.

#include <cuda_runtime.h>

#define THREADS 256
#define CHUNK 8  // slots of a row a thread loads at once

extern "C" __global__ void __launch_bounds__(THREADS) rank_perm_scatter(
    const int* __restrict__ pair_src, const int* __restrict__ rank_starts,
    int* __restrict__ inv, int* __restrict__ perm, int n, int num_rows)
{
    const int j = blockIdx.x * THREADS + threadIdx.x;
    if (j >= num_rows) return;
    if (j < rank_starts[n]) inv[pair_src[j]] = j;
    else perm[j] = j;  // padding keeps its place
}

// Rows [0, n) hold k_small slots each and belong to rank = row; rows
// [n, n + big_rows) hold k_big slots each, and their rank is that of any pair
// they emitted (a big row with no kept slot writes nothing).
extern "C" __global__ void __launch_bounds__(THREADS) rank_perm_rows(
    const int* __restrict__ inv, const int* __restrict__ pair_gauss,
    const int* __restrict__ rank_starts, int* __restrict__ perm,
    int n, int big_rows, int k_small, int k_big)
{
    const int row = blockIdx.x * THREADS + threadIdx.x;
    if (row >= n + big_rows) return;
    const bool small = row < n;
    const int width = small ? k_small : k_big;
    const int* slots = small ? inv + (long long)row * k_small
                             : inv + (long long)n * k_small + (long long)(row - n) * k_big;
    // a small row's rank is its own; a big row's, that of its first pair
    int place = small ? rank_starts[row] : -1;
    for (int c0 = 0; c0 < width; c0 += CHUNK) {
        int js[CHUNK];  // CHUNK slots' loads in flight, not one
#pragma unroll
        for (int u = 0; u < CHUNK; ++u) js[u] = c0 + u < width ? slots[c0 + u] : -1;
#pragma unroll
        for (int u = 0; u < CHUNK; ++u) {
            if (js[u] < 0) continue;
            if (place < 0) place = rank_starts[pair_gauss[js[u]]];
            perm[place++] = js[u];
        }
    }
}

// Launches on `stream`, allocates nothing, does not synchronise. `inv` is
// scratch of n * k_small + big_rows * k_big ints, cleared here. Returns the
// first CUDA error (0 = success).
extern "C" int rank_perm_launch(
    const void* pair_src, const void* pair_gauss, const void* rank_starts,
    void* inv, void* perm, int n, int num_rows, int k_small, int k_big,
    int big_rows, void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    const size_t slots = (size_t)n * k_small + (size_t)big_rows * k_big;
    cudaError_t err = cudaMemsetAsync(inv, 0xff, slots * sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
    if (num_rows > 0) {
        rank_perm_scatter<<<(num_rows + THREADS - 1) / THREADS, THREADS, 0, st>>>(
            (const int*)pair_src, (const int*)rank_starts, (int*)inv, (int*)perm, n, num_rows);
        const int rows = n + big_rows;
        if (rows > 0)
            rank_perm_rows<<<(rows + THREADS - 1) / THREADS, THREADS, 0, st>>>(
                (const int*)inv, (const int*)pair_gauss, (const int*)rank_starts, (int*)perm,
                n, big_rows, k_small, k_big);
    }
    return (int)cudaGetLastError();
}
