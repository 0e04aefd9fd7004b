// binning — tile binning's pair list by count, scan and stable scatter, for
// Hopper (sm_90a), plain C interface.
//
// Replaces no Pallas kernel: the JAX package's binning
// (gaussian_splat_tpu/ops/binning.py::bin_gaussians) is XLA, which sorts
// padded (tile, rank) keys with lax.sort (:633, :645). The port's plain
// version, ops/binning.py::bin_gaussians_torch, does the same with torch: an
// int64 key for every emission slot of padded (rows, k) grids, a sentinel
// where a slot holds no pair, and one 64-bit radix sort over them all. At
// 11.2M splats that is ≥ 67M slots for ~12.5M pairs, ~17 GB of sort passes,
// float grids of the σ test over every slot, and ~100 launches.
//
// No sort is needed. The key is (tile, depth rank) and the ranks are already
// in depth order; a rank emits from one row (small or big) and a rect's
// cells are distinct tiles, so each (tile, rank) occurs once. A kept cell's
// place in the tile-major list is tile_offsets[tile] + the kept, in-budget
// cells of the same tile with a lower rank: a counting sort on the tile id.
// The chain, four kernels and a few fills a render (binning_launch):
//
//   bin_rects   a thread a splat, in index order: the rect on the global
//               grid and its K-cap shrink, the tier eligibility, the σ
//               test's per-splat terms; one 32-byte record a splat, and a
//               histogram of the eligible areas (integers ≤ K). Its last
//               block decides the big tier with _top_indices' rule and no
//               sort: every eligible splat if they fit, else the areas above
//               the threshold a* that the histogram gives and, at a*, the
//               lowest indices (a scan in index order, run only when the
//               tier overflows).
//   bin_count   a thread RPT ranks, records gathered through `order`: the
//               small-cap shrink, the band clip, the cells and the exact
//               σ-bound cell test, each row's kept cells. A decoupled
//               look-back over the blocks gives each rank the pairs before
//               it (rank_starts and the budget cut, which drops a suffix of
//               ranks) and the big ranks before it (the big rows: big ranks
//               first, then the lowest other ranks as fill, a stable
//               partition). It writes the kept bytes, big_ranks, a 16-byte
//               row a rank for the scatter, and the block's histogram of its
//               in-budget kept cells by tile (in shared memory when the
//               tiles fit, SMEM_TILES).
//   bin_offsets 32 tiles a block: a column scan of those histograms, each
//               block's base in each tile, tile_counts, tile_offsets (a
//               look-back over the tile chunks), and the last sentinels.
//   bin_scatter a warp a histogram row of ranks: walks its ranks in rank
//               order, 32 kept cells a step, ranks each cell among the
//               step's cells of its tile (__match_any_sync), and writes
//               pair_tile, pair_gauss and pair_src (the cell's emission
//               slot: row·k + column, the index the sort of padded keys
//               gives) at its tile's counter (in shared memory when the
//               tiles fit); then the padding up to the budget.
//
// Every keep decision is the plain version's: each float operation is one
// correctly rounded operation in torch's order on the card (__fmul_rn and
// the like, never contracted; a division by a Python scalar is torch's
// multiply by the scalar's float reciprocal, scalar / tensor its reciprocal
// times the scalar), floorf, ceilf and logf are the functions torch's
// kernels call, and min, max and clamp keep torch's NaN rules. So every
// output equals the plain version's bit for bit. Integer sums only: two runs
// give the same bits.
//
// Bound on this card: bytes. The N-row inputs read once (~33 B a splat),
// the record written and gathered once (32 B), the kept bytes, a 16-byte row
// a rank written and read, the per-(block, tile) histograms three times and
// the budget-length pair list (12 B a pair): ~1 GB at 11.2M splats
// (utils/roofline.py::binning_cost), ~0.3 ms. Each pass makes one coalesced
// or one gathered access a row; the scatter orders its cells in registers
// and shared memory, with one 12-byte write a pair.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 256          // bin_rects and bin_count
#define ROWS_A 16            // splats a bin_rects thread
#define RPT 8                // ranks a bin_count thread
#define RANKS (THREADS * RPT)  // ranks a bin_count block
#define SMEM_TILES 11264     // tile counters that fit 44 KB of one block's shared memory
#define HIST_ENTRIES (1 << 24)  // most (row, tile) histogram entries before rows are grouped
#define FULL 0xffffffffu

// ints at the start of the scratch, zeroed before the chain
enum {
    H_RECTS_DONE, H_COUNT_NEXT, H_OFFSETS_NEXT, H_ELIGIBLE, H_CLAMPED, H_ASTAR, H_ISTAR,
    H_NB, H_TOTAL_FIT, H_NUM_PAIRS, H_DROPPED, HEADER_INTS = 16
};
// the sentinels' output, in BinningStats' order
enum { S_NUM_PAIRS, S_OVERFLOW, S_CLAMPED, S_TIER_OVERFLOW, S_DROPPED };

// look-back descriptors: 2 flag bits over a 62-bit value
#define D_AGG (1ull << 62)
#define D_INCL (2ull << 62)
#define D_VALUE ((1ull << 62) - 1)
#define V31 ((1ull << 31) - 1)

struct Params {
    int n, m;                 // splats; ranks that may emit (max_active)
    int tx_n, ty_band;        // tiles across; the band's tile rows
    int ty_global, row0;      // the global grid's tile rows; the band's first
    int tw, th;               // tile size in pixels
    int k_small, k_big, m_big, words;  // row widths, big rows, words a big row
    int budget;               // pair-list length
    int tiles;                // tx_n * ty_band
    int sigma;                // opacities given: the σ-bound cell test runs
    int groups, hist_rows;    // bin_count blocks a histogram row; the rows
    int shared_tiles;         // tiles <= SMEM_TILES
    long long s_means, s_extents, s_conics, s_opac;  // row strides, in elements
    float cutoff, log_skip;
};

// One correctly rounded operation each, never contracted.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp_min / clamp_max with a scalar: NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp_max(float v, float hi) { return v != v ? v : fminf(v, hi); }
// torch.maximum / torch.minimum: a NaN operand wins
__device__ __forceinline__ float tmax(float a, float b)
{
    return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b)
{
    return a != a ? a : (b != b ? b : fminf(a, b));
}
// _tile_index: torch.clamp(v, lo, hi).to(int32); NaN converts to 0 on the card
__device__ __forceinline__ int tile_index(float v, int lo, int hi)
{
    return (int)(v != v ? v : fminf(fmaxf(v, (float)lo), (float)hi));
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// ---- warp and block scans ---------------------------------------------------

__device__ __forceinline__ int warp_incl_scan(int v)
{
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL, v, d);
        if (lane >= d) v += y;
    }
    return v;
}

__device__ __forceinline__ unsigned long long warp_incl_scan64(unsigned long long v)
{
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const unsigned long long y = __shfl_up_sync(FULL, v, d);
        if (lane >= d) v += y;
    }
    return v;
}

__device__ __forceinline__ unsigned long long warp_sum64(unsigned long long v)
{
#pragma unroll
    for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
    return v;
}

__device__ __forceinline__ int warp_max(int v)
{
#pragma unroll
    for (int d = 16; d; d >>= 1) v = max(v, __shfl_xor_sync(FULL, v, d));
    return v;
}

// Exclusive scan over the block's THREADS threads in thread order; `total`
// gets the block's sum. Every thread of the block calls it.
__device__ __forceinline__ unsigned long long block_excl_scan(unsigned long long v,
                                                              unsigned long long& total,
                                                              unsigned long long* s_warp)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned long long incl = warp_incl_scan64(v);
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    unsigned long long before = 0;
    total = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
        const unsigned long long x = s_warp[w];
        if (w < warp) before += x;
        total += x;
    }
    __syncthreads();  // s_warp is read again by the next call
    return before + incl - v;
}

// ---- decoupled look-back ----------------------------------------------------

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p)
{
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v)
{
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// Block `bid`'s exclusive prefix of the blocks' values (sums below 2^62),
// blocks numbered in the order they started (so every block waited on is
// running or done). Called by all lanes of one warp; publishes `agg` at
// once and the inclusive prefix when found. The descriptors start at 0.
__device__ unsigned long long lookback(unsigned long long* desc, int bid, unsigned long long agg)
{
    const int lane = threadIdx.x & 31;
    if (lane == 0) st_relaxed(&desc[bid], (bid == 0 ? D_INCL : D_AGG) | agg);
    unsigned long long excl = 0;
    int j = bid - 1;
    while (j >= 0) {
        const int idx = j - lane;
        // before block 0: an inclusive prefix of 0
        const unsigned long long d = idx >= 0 ? ld_relaxed(&desc[idx]) : D_INCL;
        const unsigned flag = (unsigned)(d >> 62);
        const unsigned incl = __ballot_sync(FULL, flag == 2);
        const unsigned empty = __ballot_sync(FULL, flag == 0);
        // the lanes up to the nearest inclusive prefix
        const unsigned upto = incl ? (incl & (0u - incl)) * 2u - 1u : FULL;
        if (empty & upto) continue;  // a block there has not published yet
        excl += warp_sum64(((upto >> lane) & 1u) ? (d & D_VALUE) : 0ull);
        if (incl) break;
        j -= 32;
    }
    if (lane == 0) st_relaxed(&desc[bid], D_INCL | (excl + agg));
    return excl;
}

// ---- rects ------------------------------------------------------------------

struct Rect {
    int x0, y0, w, h;
};

// _shrink_to_cap for one rect with area > cap: isotropically around the
// mean's tile, on the global grid.
__device__ __forceinline__ void shrink(Rect& r, int cap, float mx, float my, float inv_tw,
                                       float inv_th, const Params& P)
{
    const int area = r.w * r.h;
    const float s = __fsqrt_rn(mul(dvd(1.0f, (float)max(area, 1)), (float)cap));
    int wc = max((int)mul((float)r.w, s), 1);
    int hc = max((int)mul((float)r.h, s), 1);
    wc = min(wc, cap / max(hc, 1));
    hc = min(hc, cap / max(wc, 1));
    wc = max(wc, 1);
    hc = max(hc, 1);
    const int cx = tile_index(floorf(mul(mx, inv_tw)), 0, P.tx_n - 1);
    const int cy = tile_index(floorf(mul(my, inv_th)), 0, P.ty_global - 1);
    r.x0 = min(max(cx - (wc - 1) / 2, 0), P.tx_n - wc);
    r.y0 = min(max(cy - (hc - 1) / 2, 0), P.ty_global - hc);
    r.w = wc;
    r.h = hc;
}

// quantize_extent_up: ceil(x·256)·(1/256)
__device__ __forceinline__ float quantize_up(float x)
{
    return mul(ceilf(mul(x, 256.0f)), 0.00390625f);
}

// A record's rect: tx0 | ty0 << 16 and w | valid << 15 | h << 16 (every
// count of tiles < 2^15, checked by the wrapper)
__device__ __forceinline__ Rect unpack(const float4& g, bool& valid)
{
    const int xy = __float_as_int(g.z), wh = __float_as_int(g.w);
    valid = (wh >> 15) & 1;
    return {xy & 0xffff, xy >> 16, wh & 0x7fff, (wh >> 16) & 0x7fff};
}

// ---- the σ-bound cell test (_cell_sigma_min) ----------------------------------

struct Sig {
    float mx, my, a2, b, c2, bound, inv2a, inv2c;
};

__device__ __forceinline__ Sig sig_terms(const float4& g, const float4& q)
{
    Sig s;
    s.mx = g.x;
    s.my = g.y;
    s.a2 = q.x;
    s.b = q.y;
    s.c2 = q.z;
    s.bound = q.w;
    s.inv2a = dvd(1.0f, clamp_min(mul(2.0f, q.x), 1e-12f));
    s.inv2c = dvd(1.0f, clamp_min(mul(2.0f, q.z), 1e-12f));
    return s;
}

__device__ __forceinline__ float quad(const Sig& s, float dx, float dy)
{
    return add(mul(mul(s.a2, dx), dx), mul(add(mul(s.c2, dy), mul(s.b, dx)), dy));
}

// Whether the {σ ≤ bound} ellipse reaches the pixel-centre box of tile
// (tx, ty) of the global grid: the box's exact minimum of σ, 0 if the mean
// is inside, else the least of the four edges' clamped 1-D minimisers.
__device__ __forceinline__ bool reaches(const Sig& s, int tx, int ty, const Params& P)
{
    const float x0 = add(mul((float)tx, (float)P.tw), 0.5f);
    const float y0 = add(mul((float)ty, (float)P.th), 0.5f);
    const float dx0 = sub(x0, s.mx), dx1 = add(dx0, (float)(P.tw - 1));
    const float dy0 = sub(y0, s.my), dy1 = add(dy0, (float)(P.th - 1));
    const bool inside = dx0 <= 0.0f && 0.0f <= dx1 && dy0 <= 0.0f && 0.0f <= dy1;
    const float nb = -s.b;
    const float ex0 = quad(s, dx0, tmin(tmax(mul(mul(nb, dx0), s.inv2c), dy0), dy1));
    const float ex1 = quad(s, dx1, tmin(tmax(mul(mul(nb, dx1), s.inv2c), dy0), dy1));
    const float ey0 = quad(s, tmin(tmax(mul(mul(nb, dy0), s.inv2a), dx0), dx1), dy0);
    const float ey1 = quad(s, tmin(tmax(mul(mul(nb, dy1), s.inv2a), dx0), dx1), dy1);
    const float smin = tmin(tmin(ex0, ex1), tmin(ey0, ey1));
    return (inside ? 0.0f : smin) <= s.bound;
}

// ---- bin_rects ------------------------------------------------------------------

// In the last block: the big tier. nb = min(eligible, m_big) splats; when the
// eligible ones overflow it, a* is the largest area with at least m_big
// eligible splats at or above it, and at a* the lowest indices win: istar is
// one past the index of the need-th splat at a*.
__device__ void decide_tier(const float4* rec, int* hdr, const int* area_hist, int* scalars,
                            int* bins, const Params& P)
{
    __shared__ int s_astar, s_need;
    __shared__ int s_warp[THREADS / 32];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int eligible = atomicAdd(&hdr[H_ELIGIBLE], 0);
    const int nb = min(eligible, P.m_big);
    if (tid == 0) {
        scalars[S_CLAMPED] = atomicAdd(&hdr[H_CLAMPED], 0) + (eligible - nb);
        scalars[S_TIER_OVERFLOW] = eligible - nb;
        hdr[H_NB] = nb;
        hdr[H_ASTAR] = P.k_small;  // no overflow: every eligible area is above it
        hdr[H_ISTAR] = 0;
    }
    if (eligible <= P.m_big) return;
    for (int k = tid; k <= P.k_big; k += THREADS) bins[k] = atomicAdd((int*)&area_hist[k], 0);
    __syncthreads();
    if (tid == 0) {
        int above = 0, a = P.k_big;
        for (; a > P.k_small; --a) {
            if (above + bins[a] >= P.m_big) break;
            above += bins[a];
        }
        s_astar = a;
        s_need = P.m_big - above;
        hdr[H_ASTAR] = a;
    }
    __syncthreads();
    const int astar = s_astar, need = s_need;
    int run = 0;
    for (long long base = 0; base < P.n; base += THREADS) {
        const long long i = base + tid;
        bool at = false;
        if (i < P.n) {
            bool valid;
            const Rect r = unpack(__ldcg(&rec[2 * i]), valid);
            at = r.w * r.h == astar;
        }
        const unsigned b = __ballot_sync(FULL, at);
        if (lane == 0) s_warp[warp] = __popc(b);
        __syncthreads();
        int before = run + __popc(b & ((1u << lane) - 1u)), total = 0;
#pragma unroll
        for (int w = 0; w < THREADS / 32; ++w) {
            if (w < warp) before += s_warp[w];
            total += s_warp[w];
        }
        if (at && before + 1 == need) hdr[H_ISTAR] = (int)(i + 1);
        __syncthreads();
        run += total;
        if (run >= need) break;
    }
}

__global__ void __launch_bounds__(THREADS) bin_rects(
    const float* __restrict__ means2d, const float* __restrict__ extents,
    const int* __restrict__ radii, const uint8_t* __restrict__ valid,
    const float* __restrict__ conics, const float* __restrict__ opac, float4* __restrict__ rec,
    int* __restrict__ hdr, int* __restrict__ area_hist, int* __restrict__ scalars, Params P)
{
    extern __shared__ int bins[];  // k_big + 1
    __shared__ int s_last;
    __shared__ int s_warp[2][THREADS / 32];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    for (int k = tid; k <= P.k_big; k += THREADS) bins[k] = 0;
    __syncthreads();
    const float inv_tw = dvd(1.0f, (float)P.tw), inv_th = dvd(1.0f, (float)P.th);
    int eligible = 0, clamped = 0;
    for (int u = 0; u < ROWS_A; ++u) {
        const long long i = ((long long)blockIdx.x * ROWS_A + u) * THREADS + tid;
        if (i >= P.n) break;
        const float mx = means2d[i * P.s_means], my = means2d[i * P.s_means + 1];
        float rx, ry;
        if (extents) {
            rx = quantize_up(extents[i * P.s_extents]);
            ry = quantize_up(extents[i * P.s_extents + 1]);
        } else {
            rx = ry = (float)radii[i];
        }
        const bool v = valid[i] != 0;
        // tile_rects: the rect on the global grid, then the K cap
        Rect r;
        r.x0 = tile_index(floorf(mul(sub(mx, rx), inv_tw)), 0, P.tx_n);
        const int x1 = tile_index(ceilf(mul(add(mx, rx), inv_tw)), 0, P.tx_n);
        r.y0 = tile_index(floorf(mul(sub(my, ry), inv_th)), 0, P.ty_global);
        const int y1 = tile_index(ceilf(mul(add(my, ry), inv_th)), 0, P.ty_global);
        r.w = v ? x1 - r.x0 : 0;
        r.h = v ? y1 - r.y0 : 0;
        if (r.w * r.h > P.k_big) {
            shrink(r, P.k_big, mx, my, inv_tw, inv_th, P);
            ++clamped;
        }
        const int area = r.w * r.h;
        if (area > P.k_small) {
            ++eligible;
            atomicAdd(&bins[area], 1);
        }
        rec[2 * i] = make_float4(mx, my, __int_as_float(r.x0 | (r.y0 << 16)),
                                 __int_as_float(r.w | ((int)v << 15) | (r.h << 16)));
        if (P.sigma) {
            const float* c = conics + i * P.s_conics;
            float bound = clamp_max(sub(logf(clamp_min(opac[i * P.s_opac], 1e-30f)), P.log_skip),
                                    P.cutoff);
            bound = add(v ? bound : -1.0f, 1e-4f);
            rec[2 * i + 1] = make_float4(mul(0.5f, c[0]), c[1], mul(0.5f, c[2]), bound);
        }
    }
    eligible = (int)warp_sum64(eligible);
    clamped = (int)warp_sum64(clamped);
    if (lane == 0) {
        s_warp[0][warp] = eligible;
        s_warp[1][warp] = clamped;
    }
    __syncthreads();
    for (int k = tid; k <= P.k_big; k += THREADS)
        if (bins[k]) atomicAdd(&area_hist[k], bins[k]);
    if (tid == 0) {
        int e = 0, c = 0;
        for (int w = 0; w < THREADS / 32; ++w) {
            e += s_warp[0][w];
            c += s_warp[1][w];
        }
        if (e) atomicAdd(&hdr[H_ELIGIBLE], e);
        if (c) atomicAdd(&hdr[H_CLAMPED], c);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(&hdr[H_RECTS_DONE], 1) == (int)gridDim.x - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    decide_tier(rec, hdr, area_hist, scalars, bins, P);
}

// ---- bin_count ------------------------------------------------------------------

// One rank's emission row: its rect after the tier's shrink and the band
// clip (band-local rows), and whether it is a big row.
struct Row {
    Rect r;
    bool big, valid;
};

__device__ __forceinline__ Row rank_row(const float4& g, long long i, int astar, int istar,
                                        float inv_tw, float inv_th, const Params& P)
{
    Row R;
    R.r = unpack(g, R.valid);
    const int area = R.r.w * R.r.h;
    R.big = area > P.k_small && (area > astar || (area == astar && i < istar));
    if (!R.big && area > P.k_small) shrink(R.r, P.k_small, g.x, g.y, inv_tw, inv_th, P);
    const int y1 = clampi(R.r.y0 + R.r.h - P.row0, 0, P.ty_band);
    R.r.y0 = clampi(R.r.y0 - P.row0, 0, P.ty_band);
    R.r.h = y1 - R.r.y0;
    return R;
}

// The kept cells of a row of at most 32 cells, bit c for cell c (row-major).
__device__ __forceinline__ unsigned small_mask(const Rect& r, const Sig* s, const Params& P)
{
    const int area = r.w * r.h;
    if (!s) return area >= 32 ? FULL : (1u << area) - 1u;
    unsigned mask = 0;
    int x = 0, y = 0;
    for (int c = 0; c < area; ++c) {
        if (reaches(*s, r.x0 + x, r.y0 + y + P.row0, P)) mask |= 1u << c;
        if (++x == r.w) {
            x = 0;
            ++y;
        }
    }
    return mask;
}

// Walks a big row's cells 32 at a time: f(word index, kept bits).
template <class F>
__device__ __forceinline__ void big_words_of(const Rect& r, const Sig* s, const Params& P, F f)
{
    const int area = r.w * r.h;
    int x = 0, y = 0;
    for (int c0 = 0; c0 < area; c0 += 32) {
        unsigned bits = 0;
        const int end = min(area - c0, 32);
        for (int c = 0; c < end; ++c) {
            if (!s || reaches(*s, r.x0 + x, r.y0 + y + P.row0, P)) bits |= 1u << c;
            if (++x == r.w) {
                x = 0;
                ++y;
            }
        }
        f(c0 >> 5, bits);
    }
}

__global__ void __launch_bounds__(THREADS) bin_count(
    const long long* __restrict__ order, const float4* __restrict__ rec, int* __restrict__ hdr,
    unsigned long long* __restrict__ desc, int* __restrict__ rank_starts,
    uint8_t* __restrict__ kept_small, uint8_t* __restrict__ kept_big,
    int* __restrict__ big_ranks, int4* __restrict__ rows, unsigned* __restrict__ big_words,
    int* __restrict__ hist, Params P)
{
    extern __shared__ int tile_hist[];  // tiles, when they fit
    __shared__ int s_bid;
    __shared__ unsigned long long s_warp[THREADS / 32];
    __shared__ unsigned long long s_excl;
    __shared__ int s_red[2][THREADS / 32];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (tid == 0) s_bid = atomicAdd(&hdr[H_COUNT_NEXT], 1);
    if (P.shared_tiles)
        for (int t = tid; t < P.tiles; t += THREADS) tile_hist[t] = 0;
    __syncthreads();
    const int bid = s_bid;
    const long long r0 = (long long)bid * RANKS;
    const int astar = hdr[H_ASTAR], istar = hdr[H_ISTAR], nb = hdr[H_NB];
    const float inv_tw = dvd(1.0f, (float)P.tw), inv_th = dvd(1.0f, (float)P.th);

    // -- 1. each rank's row and its kept cells --------------------------------
    unsigned mask[RPT];  // small rows: the kept cells
    int info[RPT];       // the row's kept cells | big << 16
    int geo_xy[RPT], geo_wh[RPT];
    int dropped = 0;
    unsigned long long agg = 0;  // kept cells | big ranks << 32
#pragma unroll
    for (int u = 0; u < RPT; ++u) {
        const long long r = r0 + u * THREADS + tid;
        mask[u] = 0;
        info[u] = 0;
        geo_xy[u] = geo_wh[u] = 0;
        if (r < P.n) {
            const long long i = order[r];
            const float4 g = rec[2 * i];
            const Row R = rank_row(g, i, astar, istar, inv_tw, inv_th, P);
            int count = 0;
            if (r < P.m) {
                Sig s;
                if (P.sigma && R.r.w * R.r.h > 0) s = sig_terms(g, rec[2 * i + 1]);
                const Sig* sp = P.sigma ? &s : nullptr;
                if (!R.big) {
                    mask[u] = small_mask(R.r, sp, P);
                    count = __popc(mask[u]);
                } else {
                    big_words_of(R.r, sp, P, [&](int, unsigned bits) { count += __popc(bits); });
                }
                geo_xy[u] = R.r.x0 | (R.r.y0 << 16);
                geo_wh[u] = R.r.w | (R.r.h << 16);
            } else {
                dropped += R.valid;
            }
            info[u] = count | ((int)R.big << 16);
            agg += (unsigned long long)count + ((unsigned long long)R.big << 32);
        }
    }

    // -- 2. the ranks before the block: look-back --------------------------------
    agg = warp_sum64(agg);
    if (lane == 0) s_warp[warp] = agg;
    __syncthreads();
    if (warp == 0) {
        unsigned long long a = warp_sum64(lane < THREADS / 32 ? s_warp[lane] : 0ull);
        a = (a & 0xffffffffull) | ((a >> 32) << 31);  // two 31-bit fields
        const unsigned long long e = lookback(desc, bid, a);
        if (lane == 0) s_excl = e;
    }
    __syncthreads();
    long long run_p = (long long)(s_excl & V31), run_b = (long long)((s_excl >> 31) & V31);
    int fit_max = run_p <= P.budget ? (int)run_p : 0;
    int* hist_row = hist + (long long)(bid / P.groups) * P.tiles;

    // -- 3. rank_starts, the budget cut, the big rows, the outputs --------------
#pragma unroll
    for (int u = 0; u < RPT; ++u) {
        const long long r = r0 + u * THREADS + tid;
        const int count = info[u] & 0xffff;
        const bool big = (info[u] >> 16) & 1;
        unsigned long long tot;
        const unsigned long long pre = block_excl_scan(
            (unsigned long long)count | ((unsigned long long)big << 32), tot, s_warp);
        if (r < P.n) {
            const long long p_incl = run_p + (long long)(pre & 0xffffffffull) + count;
            const long long b_before = run_b + (long long)(pre >> 32);
            const bool fits = p_incl <= P.budget;
            if (fits) fit_max = max(fit_max, (int)p_incl);
            int j = -1;  // the big row this rank owns
            if (big) {
                j = (int)b_before;
            } else {
                const long long q = r - b_before;  // non-big ranks before this one
                if (q < P.m_big - nb) j = nb + (int)q;
            }
            if (j >= 0) big_ranks[j] = (int)r;
            if (r < P.m) {
                if (r == 0) rank_starts[0] = 0;
                rank_starts[r + 1] = (int)p_incl;  // bin_scatter cuts the suffix past the budget
                if (r == P.m - 1) hdr[H_NUM_PAIRS] = (int)p_incl;
                const int kept = fits ? count : 0;
                const Rect rr = {geo_xy[u] & 0xffff, geo_xy[u] >> 16, geo_wh[u] & 0xffff,
                                 geo_wh[u] >> 16};
                auto add_tile = [&](int c) {
                    const int tile = (rr.y0 + c / rr.w) * P.tx_n + rr.x0 + c % rr.w;
                    if (P.shared_tiles)
                        atomicAdd(&tile_hist[tile], 1);
                    else
                        atomicAdd(&hist_row[tile], 1);
                };
                int slot, tag;
                if (!big) {
                    slot = (int)r * P.k_small;
                    tag = (int)mask[u];
                    if (kept) {
                        for (unsigned b = mask[u]; b; b &= b - 1) {
                            const int c = __ffs(b) - 1;
                            kept_small[(long long)slot + c] = 1;
                            add_tile(c);
                        }
                    }
                } else {
                    slot = P.m * P.k_small + j * P.k_big;
                    tag = j;
                    if (kept) {
                        const long long i = order[r];
                        const float4 g = rec[2 * i];
                        Sig s;
                        if (P.sigma) s = sig_terms(g, rec[2 * i + 1]);
                        big_words_of(rr, P.sigma ? &s : nullptr, P, [&](int wd, unsigned bits) {
                            big_words[(long long)j * P.words + wd] = bits;
                            for (unsigned b = bits; b; b &= b - 1) {
                                const int c = 32 * wd + __ffs(b) - 1;
                                kept_big[(long long)j * P.k_big + c] = 1;
                                add_tile(c);
                            }
                        });
                    }
                }
                rows[r] = make_int4(geo_xy[u], rr.w | ((int)big << 15) | (kept << 16), slot, tag);
            }
        }
        run_p += (long long)(tot & 0xffffffffull);
        run_b += (long long)(tot >> 32);
    }

    // -- 4. the block's sums: total_fit, dropped, its tile histogram ------------
    fit_max = warp_max(fit_max);
    dropped = (int)warp_sum64(dropped);
    if (lane == 0) {
        s_red[0][warp] = fit_max;
        s_red[1][warp] = dropped;
    }
    __syncthreads();
    if (tid == 0) {
        int f = 0, d = 0;
        for (int w = 0; w < THREADS / 32; ++w) {
            f = max(f, s_red[0][w]);
            d += s_red[1][w];
        }
        if (f) atomicMax(&hdr[H_TOTAL_FIT], f);
        if (d) atomicAdd(&hdr[H_DROPPED], d);
    }
    if (P.shared_tiles && r0 < P.m) {
        for (int t = tid; t < P.tiles; t += THREADS) {
            const int v = tile_hist[t];
            if (P.groups == 1)
                hist_row[t] = v;
            else if (v)
                atomicAdd(&hist_row[t], v);
        }
    }
}

// ---- bin_offsets ------------------------------------------------------------------

// A block of 32 × 32 threads: 32 tiles, each in 32 segments of the
// histogram rows. Turns each row's count into its base in the tile: the
// tile's offset plus the counts of the rows before it.
__global__ void __launch_bounds__(1024) bin_offsets(
    int* __restrict__ hist, int* __restrict__ hdr, unsigned long long* __restrict__ desc,
    int* __restrict__ tile_offsets, int* __restrict__ tile_counts, int* __restrict__ scalars,
    Params P)
{
    __shared__ int seg[32][33];
    __shared__ int s_bid;
    __shared__ int s_tile_tot[32], s_tile_excl[32];
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
    if (threadIdx.x == 0) s_bid = atomicAdd(&hdr[H_OFFSETS_NEXT], 1);
    __syncthreads();
    const int bid = s_bid;
    const int t = bid * 32 + tx;
    const int L = (P.hist_rows + 31) / 32;
    const int b0 = min(ty * L, P.hist_rows), b1 = min(b0 + L, P.hist_rows);
    int sum = 0;
    if (t < P.tiles)
        for (int b = b0; b < b1; ++b) sum += hist[(long long)b * P.tiles + t];
    seg[ty][tx] = sum;
    __syncthreads();
    {  // warp ty scans tile ty's 32 segments
        const int v = seg[tx][ty];
        const int incl = warp_incl_scan(v);
        seg[tx][ty] = incl - v;
        if (tx == 31) s_tile_tot[ty] = incl;
    }
    __syncthreads();
    if (ty == 0) {
        const int tot = s_tile_tot[tx];
        const int incl = warp_incl_scan(tot);
        const unsigned long long chunk =
            lookback(desc, bid, (unsigned long long)__shfl_sync(FULL, incl, 31));
        s_tile_excl[tx] = (int)chunk + incl - tot;
        if (t < P.tiles) {
            tile_offsets[t] = (int)chunk + incl - tot;
            tile_counts[t] = tot;
        }
    }
    __syncthreads();
    if (t < P.tiles) {
        int run = s_tile_excl[tx] + seg[ty][tx];
        for (int b = b0; b < b1; ++b) {
            int* p = &hist[(long long)b * P.tiles + t];
            const int v = *p;
            *p = run;
            run += v;
        }
    }
    if (bid == 0 && threadIdx.x == 0) {
        const int num_pairs = hdr[H_NUM_PAIRS];
        scalars[S_NUM_PAIRS] = num_pairs;
        scalars[S_OVERFLOW] = num_pairs - hdr[H_TOTAL_FIT];
        scalars[S_DROPPED] = hdr[H_DROPPED];
    }
}

// ---- bin_scatter ------------------------------------------------------------------

// The position of the (nth + 1)-th set bit of b.
__device__ __forceinline__ int nth_bit(unsigned b, int nth)
{
    for (; nth > 0; --nth) b &= b - 1;
    return __ffs(b) - 1;
}

__global__ void __launch_bounds__(32) bin_scatter(
    const int4* __restrict__ rows, const unsigned* __restrict__ big_words, int* __restrict__ hist,
    const int* __restrict__ hdr, int* __restrict__ pair_gauss, int* __restrict__ pair_tile,
    int* __restrict__ pair_src, int* __restrict__ rank_starts, Params P)
{
    extern __shared__ int counters[];  // tiles, when they fit
    const int lane = threadIdx.x;
    const int hb = blockIdx.x;
    int* cnt = hist + (long long)hb * P.tiles;
    if (P.shared_tiles) {
#pragma unroll 4
        for (int t = lane; t < P.tiles; t += 32) counters[t] = cnt[t];
        cnt = counters;
        __syncwarp();
    }
    const long long lo = (long long)hb * P.groups * RANKS;
    const long long hi = min((long long)P.m, lo + (long long)P.groups * RANKS);
    for (long long g = lo; g < hi; g += 32) {
        const long long r = g + lane;
        const int4 row = r < hi ? rows[r] : make_int4(0, 0, 0, 0);
        const int c = (int)((unsigned)row.y >> 16);
        const int e = warp_incl_scan(c);
        const int total = __shfl_sync(FULL, e, 31);
        for (int k0 = 0; k0 < total; k0 += 32) {
            const int k = k0 + lane;
            // the lane whose rank holds cell k of the step: lanes whose cells end by k
            int owner = 0;
#pragma unroll
            for (int step = 16; step; step >>= 1)
                if (__shfl_sync(FULL, e, owner + step - 1) <= k) owner += step;
            const int start = __shfl_sync(FULL, e - c, owner);
            const int ox = __shfl_sync(FULL, row.x, owner), oy = __shfl_sync(FULL, row.y, owner);
            const int oz = __shfl_sync(FULL, row.z, owner), ow = __shfl_sync(FULL, row.w, owner);
            const unsigned active = __ballot_sync(FULL, k < total);
            if (k < total) {
                int nth = k - start, cell;
                if (!((oy >> 15) & 1)) {
                    cell = nth_bit((unsigned)ow, nth);
                } else {
                    const unsigned* wd = big_words + (long long)ow * P.words;
                    for (int q = 0;; ++q) {
                        const unsigned b = wd[q];
                        const int pc = __popc(b);
                        if (nth < pc) {
                            cell = 32 * q + nth_bit(b, nth);
                            break;
                        }
                        nth -= pc;
                    }
                }
                const int w = oy & 0x7fff;
                const int tile = (((unsigned)ox >> 16) + cell / w) * P.tx_n + (ox & 0xffff) + cell % w;
                const unsigned peers = __match_any_sync(active, tile);
                const int old = cnt[tile];
                __syncwarp(active);
                if (lane == __ffs(peers) - 1) cnt[tile] = old + __popc(peers);
                __syncwarp(active);
                const int pos = old + __popc(peers & ((1u << lane) - 1u));
                pair_gauss[pos] = (int)(g + owner);
                pair_tile[pos] = tile;
                pair_src[pos] = oz + cell;
            }
        }
        __syncwarp();
    }
    const int total_fit = hdr[H_TOTAL_FIT];
    for (long long p = total_fit + (long long)hb * 32 + lane; p < P.budget;
         p += (long long)gridDim.x * 32) {
        pair_gauss[p] = 0;
        pair_tile[p] = P.tiles;
        pair_src[p] = 0;
    }
    if (hdr[H_NUM_PAIRS] != total_fit)  // the budget cut: ranks past it emit nothing
        for (long long r = lo + lane; r < hi; r += 32)
            rank_starts[r + 1] = min(rank_starts[r + 1], total_fit);
}

// ---- launch ------------------------------------------------------------------

struct Layout {
    long long header, bins, desc_count, desc_offsets, zero_end, records, rows, words, hist, total;
    int count_blocks, offset_blocks, groups, hist_rows, shared_tiles;
};

static Layout layout(long long n, long long m, int tiles, int k_big, int m_big)
{
    Layout L;
    long long off = 0;
    auto take = [&](long long bytes) {
        const long long at = off;
        off += (bytes + 255) & ~255ll;
        return at;
    };
    L.count_blocks = (int)((n + RANKS - 1) / RANKS);
    L.offset_blocks = (tiles + 31) / 32;
    const long long emit_blocks = (m + RANKS - 1) / RANKS;
    L.groups = (int)((emit_blocks * tiles + HIST_ENTRIES - 1) / HIST_ENTRIES);
    if (L.groups < 1) L.groups = 1;
    L.hist_rows = (int)((emit_blocks + L.groups - 1) / L.groups);
    L.shared_tiles = tiles <= SMEM_TILES;
    L.header = take(HEADER_INTS * 4);
    L.bins = take((long long)(k_big + 1) * 4);
    L.desc_count = take((long long)L.count_blocks * 8);
    L.desc_offsets = take((long long)L.offset_blocks * 8);
    L.zero_end = off;
    L.records = take(n * 32);
    L.rows = take(m * 16);
    L.words = take((long long)m_big * ((k_big + 31) / 32) * 4);
    L.hist = take((long long)L.hist_rows * tiles * 4);
    L.total = off;
    return L;
}

// Bytes of scratch that binning_launch needs.
extern "C" long long binning_scratch_bytes(long long n, long long m, int tiles, int k_big,
                                           int m_big)
{
    return layout(n, m, tiles, k_big, m_big).total;
}

// The chain on `stream`: allocates nothing, does not synchronise. Inputs
// in the splats' index order: means2d, extents (null: the radii) and conics
// with row strides in elements, valid (bool bytes), opacities (null: no σ
// test), order (int64 depth argsort). Outputs: pairs (3, budget) int32 —
// pair_gauss, pair_tile, pair_src —, tile_out (2, tiles) int32 — offsets,
// counts —, each row padded to a multiple of 4 ints (16-byte aligned rows),
// rank_starts (m + 1), kept_small (m, k_small) and kept_big
// (m_big, k_big) bool bytes, big_ranks (m_big), scalars (5) int32 in
// BinningStats' order. Returns the first CUDA error (0 = success).
extern "C" int binning_launch(
    const void* means2d, const void* extents, const void* radii, const void* valid,
    const void* conics, const void* opacities, const void* order, void* pairs, void* tile_out,
    void* rank_starts, void* kept_small, void* kept_big, void* big_ranks, void* scalars,
    void* scratch, long long n, long long m, int tx_n, int ty_band, int ty_global, int row0,
    int tw, int th, int k_small, int k_big, int m_big, long long budget, long long s_means,
    long long s_extents, long long s_conics, long long s_opac, float cutoff, float log_skip,
    void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    Params P;
    P.n = (int)n;
    P.m = (int)m;
    P.tx_n = tx_n;
    P.ty_band = ty_band;
    P.ty_global = ty_global;
    P.row0 = row0;
    P.tw = tw;
    P.th = th;
    P.k_small = k_small;
    P.k_big = k_big;
    P.m_big = m_big;
    P.words = (k_big + 31) / 32;
    P.budget = (int)budget;
    P.tiles = tx_n * ty_band;
    P.sigma = opacities != nullptr;
    P.s_means = s_means;
    P.s_extents = s_extents;
    P.s_conics = s_conics;
    P.s_opac = s_opac;
    P.cutoff = cutoff;
    P.log_skip = log_skip;
    const Layout L = layout(n, m, P.tiles, k_big, m_big);
    P.groups = L.groups;
    P.hist_rows = L.hist_rows;
    P.shared_tiles = L.shared_tiles;

    char* s = (char*)scratch;
    int* hdr = (int*)(s + L.header);
    int* area_hist = (int*)(s + L.bins);
    unsigned long long* desc_count = (unsigned long long*)(s + L.desc_count);
    unsigned long long* desc_offsets = (unsigned long long*)(s + L.desc_offsets);
    float4* rec = (float4*)(s + L.records);
    int4* rows = (int4*)(s + L.rows);
    unsigned* big_words = (unsigned*)(s + L.words);
    int* hist = (int*)(s + L.hist);
    const long long pair_row = (budget + 3) & ~3ll, tile_row = (P.tiles + 3) & ~3;
    int* pair_gauss = (int*)pairs;
    int* pair_tile = pair_gauss + pair_row;
    int* pair_src = pair_tile + pair_row;
    int* tile_offsets = (int*)tile_out;
    int* tile_counts = tile_offsets + tile_row;
    const int tile_smem = L.shared_tiles ? P.tiles * 4 : 0;

    cudaMemsetAsync(s, 0, L.zero_end, st);
    if (m * k_small) cudaMemsetAsync(kept_small, 0, m * k_small, st);
    if ((long long)m_big * k_big) cudaMemsetAsync(kept_big, 0, (long long)m_big * k_big, st);
    if (!L.shared_tiles || L.groups > 1)
        cudaMemsetAsync(hist, 0, (long long)L.hist_rows * P.tiles * 4, st);
    bin_rects<<<(int)((n + THREADS * ROWS_A - 1) / (THREADS * ROWS_A)), THREADS,
                (k_big + 1) * 4, st>>>(
        (const float*)means2d, (const float*)extents, (const int*)radii, (const uint8_t*)valid,
        (const float*)conics, (const float*)opacities, rec, hdr, area_hist, (int*)scalars, P);
    bin_count<<<L.count_blocks, THREADS, tile_smem, st>>>(
        (const long long*)order, rec, hdr, desc_count, (int*)rank_starts, (uint8_t*)kept_small,
        (uint8_t*)kept_big, (int*)big_ranks, rows, big_words, hist, P);
    bin_offsets<<<L.offset_blocks, 1024, 0, st>>>(hist, hdr, desc_offsets, tile_offsets,
                                                  tile_counts, (int*)scalars, P);
    bin_scatter<<<L.hist_rows, 32, tile_smem, st>>>(rows, big_words, hist, hdr, pair_gauss,
                                                   pair_tile, pair_src, (int*)rank_starts, P);
    return (int)cudaGetLastError();
}
