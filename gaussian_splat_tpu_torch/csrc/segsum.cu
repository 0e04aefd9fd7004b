// segsum — per-splat segment sum of per-pair gradient rows for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernel gaussian_splat_tpu/ops/pallas_raster.py::
// _segsum_kernel (launched by _segment_sum_by_rank). The function: the pairs
// of one splat (one depth rank r) lie scattered over the tile-major pair
// list; `perm` is the stable sort of the pairs by rank (padding rows keyed to
// N, so they sort to the end), and rank_starts[r] .. rank_starts[r+1] is
// rank r's slice of it. Then
//     out[r, :] = sum over i in [rank_starts[r], rank_starts[r+1]) of rows[perm[i], :]
// for r in [0, N): the gradient of the rank-ordered per-splat table.
//
// Design: the TPU form (a one-hot matmul over 512-rank blocks, with the
// rank-sorted payload carried through a multi-operand sort) is not carried
// over. Rows are read THROUGH the permutation, so the sorted (B, 12) copy is
// never written. One thread per (rank, float4 column): three neighbouring
// threads read the 48 contiguous bytes of a row and write the 48 contiguous
// bytes of the result, and each walks its segment in order. A segment is at
// most max_tiles_per_gaussian (32) pairs long, about 2.5 on average in the
// 1M-splat bench scene, so the loop is short. The order of summation is fixed and
// there are no atomics: the result is bitwise equal from run to run.
//
// Bound on this card: bytes. It reads 48 B of row and 8 B of permutation per
// pair and 4 B of rank_starts per splat, and writes 48 B per splat: about
// 190 MB at 1M splats / 2.46M pairs, 0.06 ms at 3.35 TB/s; one addition per
// value read is nothing beside that. What keeps it from the bound is the
// gather: rows of one rank are 48-byte pieces at unrelated addresses.
// Measured with chip_smoke.py on an NVIDIA H100 80GB HBM3 (700 W limit) at that
// shape: 0.11-0.13 ms a launch, against 1.6 ms for one index_add_ of the same
// rows (which is also not reproducible bit for bit).

#include <cuda_runtime.h>

#define ROW_F4 3  // float4 per row (12 floats)

extern "C" __global__ void segsum_kernel(
    const float4* __restrict__ rows,       // (B, 3) float4 per-pair rows
    const long long* __restrict__ perm,    // (B,) pair index by sorted position
    const int* __restrict__ rank_starts,   // (N + 1,)
    float4* __restrict__ out,              // (N, 3) float4
    int n)
{
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (tid >= (long long)n * ROW_F4) return;
    const int r = (int)(tid / ROW_F4);
    const int k = (int)(tid - (long long)r * ROW_F4);
    const int first = rank_starts[r];
    const int last = rank_starts[r + 1];
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int i = first; i < last; ++i) {
        const float4 v = rows[perm[i] * ROW_F4 + k];
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
    }
    out[tid] = acc;
}

// Launches on `stream`, allocates nothing, does not synchronise. Returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int segsum_launch(
    const void* rows, const void* perm, const void* rank_starts, void* out,
    int n, void* stream)
{
    if (n > 0) {
        const int threads = 256;
        const long long total = (long long)n * ROW_F4;
        const int blocks = (int)((total + threads - 1) / threads);
        segsum_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const float4*)rows, (const long long*)perm, (const int*)rank_starts,
            (float4*)out, n);
    }
    return (int)cudaGetLastError();
}
