// A measurement variant of csrc/rank_perm.cu, not built by the package: run it
// beside the package's kernel with
//     python3 scripts/torch_segsum_sweep.py --rank-source scripts/rank_perm_variants/slot_scratch_red.cu
// (the slot-scratch design's C interface: pair_src, pair_gauss, rank_starts,
// scratch, perm, n, num_rows, k_small, k_big, big_rows, stream). Same function
// as the package's.
//
// Design: the slot-scratch kernel that the package's replaced, with its one
// scattered store made an integer atomicAdd. The scratch holds one int an
// emission slot, cleared to 0 (no pair); `scatter` adds j + 1 into
// inv[pair_src[j]] (perm[j] = j for padding); `rows` gives each row a thread
// that walks its slots in order and writes each kept slot's pair to the next
// place of its rank.

#include <cuda_runtime.h>

#define THREADS 256
#define CHUNK 8  // slots of a row a thread loads at once

extern "C" __global__ void __launch_bounds__(THREADS) rank_perm_scatter(
    const int* __restrict__ pair_src, const int* __restrict__ rank_starts,
    int* __restrict__ inv, int* __restrict__ perm, int n, int num_rows)
{
    const int j = blockIdx.x * THREADS + threadIdx.x;
    if (j >= num_rows) return;
    if (j < rank_starts[n]) atomicAdd(inv + pair_src[j], j + 1);  // 0 = no pair
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
        for (int u = 0; u < CHUNK; ++u) js[u] = c0 + u < width ? slots[c0 + u] : 0;
#pragma unroll
        for (int u = 0; u < CHUNK; ++u) {
            if (js[u] <= 0) continue;
            if (place < 0) place = rank_starts[pair_gauss[js[u] - 1]];
            perm[place++] = js[u] - 1;
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
    cudaError_t err = cudaMemsetAsync(inv, 0, slots * sizeof(int), st);
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
