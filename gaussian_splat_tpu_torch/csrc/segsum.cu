// segsum — per-splat segment sum of per-pair gradient rows for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernel gaussian_splat_tpu/ops/pallas_raster.py::
// _segsum_kernel (launched by _segment_sum_by_rank). The function: the pairs
// of one splat (one depth rank r) lie scattered over the tile-major pair
// list; `perm` (int32) lists the pairs in rank order, rank_starts[r] ..
// rank_starts[r+1] being rank r's slice of it. Then
//     out[r, :] = sum over i in [rank_starts[r], rank_starts[r+1]) of rows[perm[i], :]
// for r in [0, N): the gradient of the rank-ordered per-splat table. The
// backward takes `perm` from the rank_perm kernel, which reads it from
// binning's own sort, not from a second sort of the pairs.
//
// Bound on this card: bytes. It reads 48 B of row and 4 B of permutation per
// pair and 4 B of rank_starts per splat, and writes 48 B per splat: about
// 180 MB at 1M splats / 2.46M pairs, 0.054 ms at 3.35 TB/s; one addition per
// value read is nothing beside that. The rows of one rank are 48-byte pieces
// at unrelated addresses (each touches two 32-byte sectors), so what decides
// the time is how many of those gathers are in flight. Neither the tensor
// cores nor the TMA apply: there is no matrix product (the TPU's one-hot
// matmul existed for its MXU and is not carried over), and the TMA copies
// tiles, not rows at arbitrary indices.
//
// Design: the work is split by pairs, not by ranks, so ragged segments
// (0 to max_tiles_per_gaussian pairs, 2.5 on average, any length in
// principle) leave no lane idle beside a long one, and no thread walks a
// segment: its owning warp takes it 32 * GROUPS positions a step. Times,
// and the designs measured beside this one, are in PERF.md §6
// (scripts/torch_segsum_sweep.py, chip_smoke.py).
//  * Runs. Rank r's place in the merge of ranks and sorted positions is
//    r + rank_starts[r]; its positions follow it. Warp w takes the run of
//    ITEMS places [w * ITEMS, (w + 1) * ITEMS) and OWNS the ranks whose place
//    falls in it: it sums their whole segments, following the last one past
//    the run's end, so every rank has exactly one owner, no partial sum
//    crosses warps, and empty ranks (which take a place each) are spread
//    over the warps like pairs. A 128-way search over rank_starts (three
//    rounds of probes at a million ranks) finds the run's first rank; the
//    warp stages the rank_starts of the ranks it may own in shared memory
//    and counts the owned ones by ballot.
//  * Gathers. The warp walks its positions 32 * GROUPS at a time: lane l
//    loads the int32 permutation entries of positions c + l + 32 g
//    (coalesced), then all 3 * GROUPS float4 of their rows, and only then
//    adds, so 3 * GROUPS gathers a lane are in flight; the next positions'
//    permutation entries load while these rows do.
//  * Fixed-order reduction. In each group of 32 positions a lane finds its
//    rank by binary search of the staged starts, and a segmented inclusive
//    shuffle scan (lanes of one rank only; as many steps as the group's
//    longest piece of a segment needs) sums the pieces. The lane at a
//    segment's last position writes the rank's row; a segment that runs on
//    past the group hands its sum to the next group (the carry), added in
//    front. No atomics: the order of the additions depends on the data's
//    layout alone, so the result is bitwise equal from run to run. Owned
//    ranks with no pair are written as zeros.

#include <cuda_runtime.h>

#define ROW_F4 3    // float4 per row (12 floats)
#define WARPS 8     // warps a block
#define MIN_BLOCKS 4  // blocks an SM holds at once (caps the registers)
#define ITEMS 128   // places (ranks plus positions) of a warp's run
#define GROUPS 2    // groups of 32 positions whose rows are in flight at once
#define STAGED (ITEMS + 1)  // rank_starts a warp stages: it owns <= ITEMS ranks
#define PROBES 4    // rank_starts each lane reads a round of the search
#define FULL 0xffffffffu

// Smallest r in [0, n] with r + rank_starts[r] >= target, by one warp, if
// there is one (else some r whose place falls short: the caller checks).
// Each round probes 32 * PROBES equally spaced ranks of the range (three
// rounds for a million) and keeps the stretch between the last probe that
// falls short and the first that reaches.
__device__ int first_rank_at(const int* __restrict__ rank_starts, int n,
                             long long target, int lane)
{
    int lo = 0, hi = n;  // the answer, if any, lies in [lo, hi]
    while (lo < hi) {
        const int stride = (hi - lo + 32 * PROBES - 1) / (32 * PROBES);
        int q[PROBES], s[PROBES];
#pragma unroll
        for (int k = 0; k < PROBES; ++k) {  // probe lo + (k * 32 + lane) * stride
            q[k] = min(lo + (k * 32 + lane) * stride, hi);
            s[k] = rank_starts[q[k]];
        }
        int first = -1;  // first probe, in probe order, that reaches
#pragma unroll
        for (int k = PROBES - 1; k >= 0; --k) {
            const unsigned ballot = __ballot_sync(FULL, (long long)q[k] + s[k] >= target);
            if (ballot) first = k * 32 + __ffs(ballot) - 1;
        }
        if (first < 0) {  // none: past the last probe
            lo = min(lo + (32 * PROBES - 1) * stride, hi) + 1;
            if (lo > hi) return n;  // no rank reaches: the caller finds none owned
        } else {
            hi = min(lo + first * stride, hi);
            lo = first == 0 ? hi : lo + (first - 1) * stride + 1;
        }
    }
    return lo;
}

__device__ __forceinline__ void add4(float4& a, const float4 b)
{
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
}

__device__ __forceinline__ float4 shfl_up4(const float4 v, int d)
{
    return make_float4(__shfl_up_sync(FULL, v.x, d), __shfl_up_sync(FULL, v.y, d),
                       __shfl_up_sync(FULL, v.z, d), __shfl_up_sync(FULL, v.w, d));
}

__device__ __forceinline__ float4 shfl4(const float4 v, int src)
{
    return make_float4(__shfl_sync(FULL, v.x, src), __shfl_sync(FULL, v.y, src),
                       __shfl_sync(FULL, v.z, src), __shfl_sync(FULL, v.w, src));
}

extern "C" __global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS) segsum_kernel(
    const float4* __restrict__ rows,       // (B, 3) float4 per-pair rows
    const int* __restrict__ perm,          // (B,) pair index by sorted position
    const int* __restrict__ rank_starts,   // (N + 1,)
    float4* __restrict__ out,              // (N, 3) float4
    int n)
{
    __shared__ int s_start_all[WARPS][STAGED];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int* s_start = s_start_all[warp];
    const long long run = ((long long)blockIdx.x * WARPS + warp) * ITEMS;

    // -- the ranks this warp owns: [r0, r0 + nr) ---------------------------
    // (none where the run lies past the last place, or holds positions of
    // earlier ranks only)
    const int r0 = first_rank_at(rank_starts, n, run, lane);
    if (r0 >= n) return;
    int nr = 0;
    for (int i0 = 0; i0 < STAGED; i0 += 64) {  // two loads a lane in flight
        int s[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) s[h] = rank_starts[min(r0 + i0 + 32 * h + lane, n)];
        unsigned owned[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int i = i0 + 32 * h + lane;
            const long long place = (long long)r0 + i + s[h];
            if (i < STAGED) s_start[i] = s[h];
            owned[h] = __ballot_sync(FULL, i < STAGED && r0 + i < n && place >= run
                                               && place < run + ITEMS);
        }
        nr += __popc(owned[0]) + __popc(owned[1]);
        if (owned[1] != FULL) break;  // the owned prefix ends here; s_start[nr] is staged
    }
    if (nr == 0) return;
    __syncwarp();
    const int p_lo = s_start[0], p_hi = s_start[nr];

    // the first positions' permutation entries, in flight from here on
    int src[GROUPS];
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
        const int p = p_lo + 32 * g + lane;
        src[g] = p < p_hi ? perm[p] : -1;
    }

    // -- owned ranks with no pair: zeros -----------------------------------
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int i = lane; i < nr; i += 32) {
        if (s_start[i] == s_start[i + 1]) {
            float4* o = out + (long long)(r0 + i) * ROW_F4;
            o[0] = zero;
            o[1] = zero;
            o[2] = zero;
        }
    }

    // -- their positions, 32 * GROUPS at a time ----------------------------
    float4 carry[ROW_F4] = {zero, zero, zero};  // sum so far of a segment
    bool carrying = false;                       // that runs on into the group
    for (int c = p_lo; c < p_hi; c += 32 * GROUPS) {
        float4 v[GROUPS][ROW_F4];
#pragma unroll
        for (int g = 0; g < GROUPS; ++g) {
            const float4* row = rows + (long long)max(src[g], 0) * ROW_F4;
#pragma unroll
            for (int k = 0; k < ROW_F4; ++k) v[g][k] = src[g] >= 0 ? __ldg(row + k) : zero;
        }
        // the next positions' permutation entries, in flight with these rows
#pragma unroll
        for (int g = 0; g < GROUPS; ++g) {
            const int p = c + 32 * (GROUPS + g) + lane;
            src[g] = p < p_hi ? perm[p] : -1;
        }
#pragma unroll
        for (int g = 0; g < GROUPS; ++g) {
            const int base = c + 32 * g;
            if (base >= p_hi) break;  // warp-uniform
            const int p = base + lane;
            const bool valid = p < p_hi;
            // the lane's owned rank: the last j with s_start[j] <= p
            int lo = 0, hi = nr;  // s_start[lo] <= p < s_start[hi]
            while (hi - lo > 1) {
                const int mid = (lo + hi) >> 1;
                if (s_start[mid] <= min(p, p_hi - 1)) lo = mid;
                else hi = mid;
            }
            const int seg_first = s_start[lo], seg_end = s_start[lo + 1];
            // first lane of this segment's piece in the group
            const int first_lane = max(seg_first - base, 0);
            const int piece = valid ? lane - first_lane + 1 : 0;
            const int longest = __reduce_max_sync(FULL, piece);
            // segmented inclusive scan over the lanes of one rank
            for (int d = 1; d < longest; d <<= 1) {
#pragma unroll
                for (int k = 0; k < ROW_F4; ++k) {
                    const float4 o = shfl_up4(v[g][k], d);
                    if (lane - d >= first_lane) add4(v[g][k], o);
                }
            }
            // a segment begun before the group takes the carry in front
            if (carrying && seg_first < base) {
#pragma unroll
                for (int k = 0; k < ROW_F4; ++k) {
                    float4 t = carry[k];
                    add4(t, v[g][k]);
                    v[g][k] = t;
                }
            }
            if (valid && p + 1 == seg_end) {
                float4* o = out + (long long)(r0 + lo) * ROW_F4;
#pragma unroll
                for (int k = 0; k < ROW_F4; ++k) o[k] = v[g][k];
            }
            // lane 31's segment runs on: its sum is the next group's carry
            carrying = __shfl_sync(FULL, valid && p + 1 < seg_end, 31);
            if (carrying) {
#pragma unroll
                for (int k = 0; k < ROW_F4; ++k) carry[k] = shfl4(v[g][k], 31);
            }
        }
    }
}

// Launches on `stream`, allocates nothing, does not synchronise. `num_rows`
// is B (rank_starts[n] <= B): the launch covers the n + B places, and the
// warps past n + rank_starts[n] own no rank. Returns cudaGetLastError()
// after the launch (0 = success).
extern "C" int segsum_launch(
    const void* rows, const void* perm, const void* rank_starts, void* out,
    int n, int num_rows, void* stream)
{
    if (n > 0) {
        const long long warps = ((long long)n + num_rows + ITEMS - 1) / ITEMS;
        segsum_kernel<<<(unsigned)((warps + WARPS - 1) / WARPS), WARPS * 32, 0,
                        (cudaStream_t)stream>>>(
            (const float4*)rows, (const int*)perm, (const int*)rank_starts,
            (float4*)out, n);
    }
    return (int)cudaGetLastError();
}
