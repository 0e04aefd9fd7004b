// Shared by raster_fwd.cu and raster_bwd.cu: how a block's threads lie over
// its tile, the staging of a batch of pairs (row gather and per-splat extent),
// the per-warp cull, and the per-(pixel, splat) alpha code. The backward
// kernel must take every keep decision, and round every alpha and
// transmittance, exactly as the forward kernel did, so both include THIS
// code; every operation is spelled with an explicit rounding intrinsic so that
// the compiler cannot contract the two copies differently. (_build.py hashes
// this header into both libraries' names.)
//
// table row: [mx, my, A, B | C, r, g, b | depth, op, bound, pad]
//
// Layout rule: thread p of a block -> pixel of the tile.
//   tile_w % 8 == 0 and tile_h % 4 == 0:  warp w covers the 8-wide, 4-high
//     block (w % (tile_w/8), w / (tile_w/8)) of the tile, lane l its pixel
//     (l % 8, l / 8). A splat of a few pixels' radius then meets few of a
//     tile's warps, where a 32x1 row layout lets it meet most of them. A warp
//     row is 8 neighbouring float4 = 128 B of an image: still a full sector.
//   any other tile shape: row-major, p -> (p % tile_w, p / tile_w).
// Either way a pixel runs the same operations in the same order; only which
// threads share a warp differs.
//
// The extent. For a splat with conic (A, B, C) and keep bound `bound`, every
// (dx, dy) with 0 <= sigma <= bound lies in |dx| <= hx, |dy| <= hy with
//     hx = sqrt(2*bound*C/det),  hy = sqrt(2*bound*A/det),  det = A*C - B*B.
// A warp whose pixel rectangle misses [mx-hx, mx+hx] x [my-hy, my+hy] skips
// the pair before it loads the row. The test runs lane-parallel: lane l of a
// warp tests staged pair j0 + l against the warp's rectangle (one float4 load
// and four compares for 32 pairs), a ballot gives the warp the mask of pairs
// it has to walk, and it walks the set bits in ascending order, so every pixel
// still meets its pairs in depth order. (Testing the pairs one by one, each
// lane the same pair, was measured first: at ~10 instructions a
// (warp, pair) it cost as much as it saved in raster_fwd; see PERF.md.) The
// mask is warp-uniform, so the walk does not diverge. The extent may only
// ever skip steps that splat_keep would have failed, so it is widened to
// cover float32 rounding:
//   * of the kernel's sigma. For the dx, dy the kernel computes, the rounded
//     sigma differs from the exact quadratic form by at most
//     4*2^-24*(A*dx^2 + C*dy^2) (seven rounded operations, |B dx dy| <=
//     (A dx^2 + C dy^2)/2). So a kept step satisfies the exact form with A, C
//     shrunk by (1 - 8*2^-24): its determinant is det - 16*2^-24*A*C.
//   * of det itself: three roundings, at most 3*2^-24*A*C.
//   Both are covered by taking det_lo = det - EXTENT_DET_MARGIN*A*C with
//   EXTENT_DET_MARGIN = 2^-18 (64*2^-24) in place of det. The margin is
//   relative to A*C, not to det, so it holds however strongly B*B cancels.
//   * of the two products, the division and the square root that follow
//     (2 ulp), and anything left: hx and hy are multiplied by
//     EXTENT_REL_MARGIN (1 + 2^-16) and raised by EXTENT_ABS_MARGIN (2^-6 px;
//     pixel centres are a whole pixel apart, so this costs nothing).
//   The cull compares the warp's outermost rounded offsets px - mx, exactly
//   the kernel's own dx of those pixels (rounded subtraction is monotone), so
//   the centre's magnitude needs no margin.
// bound < 0 (an invalid row; sigma >= 0 can never pass) gives an empty extent
// (-inf). A <= 0, C <= 0, det_lo <= 0, A*C below 1e-30 (products near the
// denormals) or any non-finite value gives an infinite one: never culled.
// ops/tile_raster.py::splat_extent_torch is the plain mirror, operation for
// operation.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#define ROW_F4 3  // float4 loads per table row (12 floats)
#define FULL_MASK 0xffffffffu

#define EXTENT_DET_MARGIN 3.814697265625e-06f   // 2^-18
#define EXTENT_REL_MARGIN 1.0000152587890625f   // 1 + 2^-16
#define EXTENT_ABS_MARGIN 0.015625f             // 2^-6 pixels
#define EXTENT_MIN_AC 1e-30f

// The layout rule: pixel (lx, ly) of thread p inside its tile.
__device__ __forceinline__ void tile_pixel(int p, int tile_w, int tile_h, int* lx, int* ly)
{
    if ((tile_w & 7) == 0 && (tile_h & 3) == 0) {
        const int w = p >> 5, lane = p & 31, blocks_x = tile_w >> 3;
        *lx = (w % blocks_x) * 8 + (lane & 7);
        *ly = (w / blocks_x) * 4 + (lane >> 3);
    } else {
        *lx = p % tile_w;
        *ly = p / tile_w;
    }
}

// Pixel-centre rectangle [x0, x1] x [y0, y1] (image coordinates) that holds
// every pixel of thread p's warp; (tx0, ty0) is the tile's first pixel in
// the whole frame (a band's tiles lie tile_row0 tile rows down).
struct WarpRect { float x0, x1, y0, y1; };

__device__ __forceinline__ WarpRect warp_rect(int p, int tile_w, int tile_h, int tx0, int ty0)
{
    const int first = p & ~31;
    const int last = min(first + 31, tile_w * tile_h - 1);
    int ax, ay, bx, by;
    tile_pixel(first, tile_w, tile_h, &ax, &ay);
    tile_pixel(last, tile_w, tile_h, &bx, &by);
    if (ay != by && !((tile_w & 7) == 0 && (tile_h & 3) == 0)) {
        ax = 0;              // a row-major warp that wraps spans whole rows
        bx = tile_w - 1;
    }
    WarpRect r;
    r.x0 = (float)(tx0 + ax) + 0.5f;
    r.x1 = (float)(tx0 + bx) + 0.5f;
    r.y0 = (float)(ty0 + ay) + 0.5f;
    r.y1 = (float)(ty0 + by) + 0.5f;
    return r;
}

// (mx, my, hx, hy) of one table row; see the header comment.
__device__ __forceinline__ float4 splat_extent(const float4 f0, float C, float bound)
{
    const float A = f0.z, B = f0.w;
    const float ac = __fmul_rn(A, C);
    const float det = __fsub_rn(ac, __fmul_rn(B, B));
    const float det_lo = __fsub_rn(det, __fmul_rn(EXTENT_DET_MARGIN, ac));
    const float q = __fmul_rn(2.0f, bound);
    float hx = __fsqrt_rn(__fdiv_rn(__fmul_rn(q, C), det_lo));
    float hy = __fsqrt_rn(__fdiv_rn(__fmul_rn(q, A), det_lo));
    hx = __fadd_rn(__fmul_rn(hx, EXTENT_REL_MARGIN), EXTENT_ABS_MARGIN);
    hy = __fadd_rn(__fmul_rn(hy, EXTENT_REL_MARGIN), EXTENT_ABS_MARGIN);
    const bool ok = A > 0.0f && C > 0.0f && det_lo > 0.0f && ac >= EXTENT_MIN_AC
        && isfinite(hx) && isfinite(hy) && isfinite(f0.x) && isfinite(f0.y);
    if (!ok) hx = hy = CUDART_INF_F;
    if (bound < 0.0f) hx = hy = -CUDART_INF_F;
    return make_float4(f0.x, f0.y, hx, hy);
}

// True when no pixel of the rectangle can pass the keep test of the splat
// with extent e.
__device__ __forceinline__ bool extent_misses(const float4 e, const WarpRect r)
{
    return __fsub_rn(r.x0, e.x) > e.z || __fsub_rn(r.x1, e.x) < -e.z
        || __fsub_rn(r.y0, e.y) > e.w || __fsub_rn(r.y1, e.y) < -e.w;
}

// The warp's cull of the staged pairs [j0, j0 + 32) of a batch of nb: bit l of
// the result is set when pair j0 + l may touch the warp's rectangle. Lane l
// tests pair j0 + l; every lane of the warp must call it (blocks are launched
// with whole warps).
__device__ __forceinline__ unsigned warp_live_pairs(
    const float4* __restrict__ ext, int j0, int nb, const WarpRect r)
{
    const int j = j0 + (threadIdx.x & 31);
    return __ballot_sync(FULL_MASK, j < nb && !extent_misses(ext[min(j, nb - 1)], r));
}

// Stage `nb` pairs of the pair list [first, first + nb): one thread per pair
// gathers its row (three float4, straight from the per-splat table) into
// `rows` and writes the splat's extent into `ext`.
__device__ __forceinline__ void stage_pairs(
    float4* __restrict__ rows, float4* __restrict__ ext,
    const float4* __restrict__ table, const int* __restrict__ pair_gauss,
    int first, int nb)
{
    for (int j = threadIdx.x; j < nb; j += blockDim.x) {
        const float4* src = table + (size_t)pair_gauss[first + j] * ROW_F4;
        const float4 f0 = src[0], f1 = src[1], f2 = src[2];
        rows[j * ROW_F4 + 0] = f0;
        rows[j * ROW_F4 + 1] = f1;
        rows[j * ROW_F4 + 2] = f2;
        ext[j] = splat_extent(f0, f1.x, f2.z);
    }
}

// sigma = (A2*dx)*dx + (C2*dy + B*dx)*dy with A2 = 0.5*A, C2 = 0.5*C, every
// operation rounded alone (the order of ops/falloff.py::sigma_quadform).
__device__ __forceinline__ float splat_sigma(
    float px, float py, const float4 f0, float C, float* dx_out, float* dy_out)
{
    const float dx = __fsub_rn(px, f0.x);
    const float dy = __fsub_rn(py, f0.y);
    const float A2 = __fmul_rn(0.5f, f0.z);
    const float C2 = __fmul_rn(0.5f, C);
    *dx_out = dx;
    *dy_out = dy;
    return __fadd_rn(
        __fmul_rn(__fmul_rn(A2, dx), dx),
        __fmul_rn(__fadd_rn(__fmul_rn(C2, dy), __fmul_rn(f0.w, dx)), dy));
}

__device__ __forceinline__ bool splat_keep(float sigma, float bound)
{
    return sigma >= 0.0f && sigma <= bound;
}

// op * exp(-sigma), before the clamp (expf, never __expf)
__device__ __forceinline__ float splat_alpha_raw(float op, float sigma)
{
    return __fmul_rn(op, expf(-sigma));
}

// One compositing step of a kept pair: the weight alpha*T, the four
// accumulations and the transmittance update, in the forward's rounding.
__device__ __forceinline__ float composite_step(
    float alpha, const float4 f1, float depth,
    float* T, float* r, float* g, float* b, float* d)
{
    const float w = __fmul_rn(alpha, *T);
    *r = __fmaf_rn(f1.y, w, *r);
    *g = __fmaf_rn(f1.z, w, *g);
    *b = __fmaf_rn(f1.w, w, *b);
    *d = __fmaf_rn(depth, w, *d);
    *T = __fmul_rn(*T, __fsub_rn(1.0f, alpha));
    return w;
}

// Proof of the cull (chip_smoke.py): a block adds its kept steps inside the
// image and its (warp, pair)s not culled into counters[2*tile + {0, 1}].
__device__ __forceinline__ void add_counters(
    int* __restrict__ counters, int tile, int kept_steps, int live_warp_pairs)
{
    if (kept_steps != 0) atomicAdd(counters + 2 * tile, kept_steps);
    if ((threadIdx.x & 31) == 0 && live_warp_pairs != 0)
        atomicAdd(counters + 2 * tile + 1, live_warp_pairs);
}
