// raster_fwd — forward tile rasterizer for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel gaussian_splat_tpu/ops/pallas_raster.py::_fwd_kernel
// (launched by _raster_forward). What it computes, per tile: walk the tile's
// depth-ordered pair segment front to back; for each (pixel, splat)
//     sigma = (A2*dx)*dx + (C2*dy + B*dx)*dy,  A2 = 0.5*A, C2 = 0.5*C
//     keep  = sigma >= 0 && sigma <= bound
//     alpha = keep ? min(op * exp(-sigma), alpha_clamp) : 0
//     acc  += c * alpha * T   for r, g, b, depth;   T *= (1 - alpha)
// and write r, g, b, depth and T_final. With sat_check the block leaves the
// loop, at batch granularity, once every pixel of the tile has
// T < trans_eps (deviation <= trans_eps); without it the whole segment is
// walked.
//
// Design (one thread block per tile, one thread per pixel): nothing of the
// TPU kernel's layout is carried over. The block reads its own segment
// bounds, stages BATCH pairs at a time in shared memory, and every thread
// runs the plain recurrence in registers. The pair gather is FUSED: the
// kernel takes the rank-ordered per-splat table (N, 12) and the pair list
// (B,) and gathers the rows into shared memory itself, so nothing of size
// B x features is ever written to device memory. Results go straight into
// the (H, W, 4) and (H, W) images, the ragged right/bottom edge masked.
//
// Rounding. The keep test must round exactly as the plain PyTorch version
// (ops/tile_raster.py) rounds: a pair kept by one and dropped by the other is
// a ~4e-3 pixel error. So sigma is spelled with __fmul_rn/__fadd_rn in the
// shared evaluation order (nvcc would otherwise contract a*b+c into FMA,
// which eager torch ops never do), exp is expf (never __expf; this file is
// built without -use_fast_math), and the per-splat bound arrives as a table
// column computed once in torch, so no logarithm sits in the keep decision.
// T is kept as a running PRODUCT, where the plain version and the reference
// take exp of a log1p sum: the two differ by rounding only (a few ulp per
// factor), inside the stated tolerance of atol 3e-5 + rtol 1e-4.
//
// Bound on this card. At 1M splats / 1920x1080 (2.46M pairs) the kernel reads
// the 48 MB table, 10 MB of pair indices and the tile segments, and writes
// 41 MB of images: ~0.03 ms at the H100's 3.35 TB/s. Against that stand the
// (pixel, splat) steps: 9 flops each for the offsets and sigma, and 14 more
// (one expf among them) only where the keep test passes. Of 2.46M pairs x 512
// pixels the early exit leaves 0.74 G steps inside the image, of which 0.11 G
// pass the test: 8.2 GFLOP, ~0.12 ms at 67 TFLOP/s. So it is bound by FP32
// throughput, not by memory, and what it really pays for is instruction slots: 85 %
// of the steps fail the keep test, and a 32x1 pixel row per warp with sigma
// evaluated before anything could be skipped spent most of 0.85 ms on them.
//
// What the design does about it (raster_common.cuh): a warp is an 8x4 pixel
// block, so a splat of a few pixels' radius meets few of the tile's 16 warps;
// while a batch is staged one thread per pair also writes the splat's
// conservative extent (one float4), and in the pair loop a warp tests 32
// staged pairs at once, each lane one pair's extent against the warp's
// rectangle, and walks only the pairs of the resulting mask. A pair the warp
// cannot touch costs it a fraction of an instruction, not three loads and
// sigma. The mask is warp-uniform (no divergence) and the cull may only skip
// steps the keep test would have failed: the keep decision itself is still
// splat_keep(splat_sigma(...)), and a pixel's own sequence of operations is
// unchanged, so the images are bitwise those of the row-per-warp kernel.
// BATCH and the block-wide exit are as before, so `walked` and T_final are
// the same work. Blocks are launched with whole warps (the tile's pixels
// rounded up to 32 threads), as the cull's ballot needs.
// Measured with chip_smoke.py on an NVIDIA H100 80GB HBM3 (700.00 W limit), 1M
// splats / 1920x1080: 0.50 ms a launch (25 % of that bound's rate) where the
// row-per-warp kernel took 0.85 ms in the same call; 33 % of the
// (warp, pair)s pass the cull; 47 registers, 16 KB of shared memory, no
// spills, two 512-thread blocks per SM. What is left is the instruction count
// of the live (warp, pair)s and that occupancy (PERF.md, sections 6 and 7).
//
// `walked` (optional, may be null) returns the pairs each block walked before
// it left its loop. The backward kernel (raster_bwd.cu) takes it as its
// segment length, so that it stops where this kernel stopped, and
// chip_smoke.py needs it to state the bound above: the work depends on the
// data through the early exit, and only the kernel knows where each block
// stopped. `counters` (optional, may be null; (T, 2) int32, zeroed by the
// caller) receives per tile the kept steps inside the image and the
// (warp, pair)s that were not culled: chip_smoke.py holds the first against
// its own count to show that the cull dropped nothing.
//
// The layout, the staging, the cull and the per-(pixel, splat) alpha code
// live in raster_common.cuh, shared with the backward kernel.
//
// Bands (the sharded path, parallel/sharded_render.py). `tile_row0` is the
// first tile row of the band in the whole frame, as `trow0` of the TPU
// kernel: the block of tile t evaluates its pixel centres, and places its
// warps' cull rectangles, at global row (t / tiles_x + tile_row0) * tile_h
// + ly, so every alpha is the one the whole frame would give; the images
// are the band's own (`height` rows), written at band-local row
// (t / tiles_x) * tile_h + ly. With tile_row0 = 0 the kernel is the
// whole-frame kernel, operation for operation.

#include "raster_common.cuh"

#define BATCH 256        // pairs staged per shared-memory batch

// table row: [mx, my, A, B | C, r, g, b | depth, op, bound, pad]
template <bool COUNT>
__global__ void __launch_bounds__(1024) raster_fwd_kernel(
    const float4* __restrict__ table,      // (N, 3) float4
    const int* __restrict__ pair_gauss,    // (B,)
    const int* __restrict__ tile_offsets,  // (T,)
    const int* __restrict__ tile_counts,   // (T,)
    float4* __restrict__ out_rgbd,         // (H, W) float4: r, g, b, depth
    float* __restrict__ out_tfinal,        // (H, W)
    int* __restrict__ walked,              // (T,) pairs walked per tile, or null
    int* __restrict__ counters,            // (T, 2), only read when COUNT
    int tiles_x, int tile_w, int tile_h, int width, int height, int tile_row0,
    float alpha_clamp, float trans_eps, int sat_check)
{
    __shared__ float4 rows[BATCH * ROW_F4];
    __shared__ float4 ext[BATCH];

    const int t = blockIdx.x;
    const int p = threadIdx.x;             // blockDim.x = tile pixels rounded up to 32
    const int tx0 = (t % tiles_x) * tile_w;
    const int ty0 = (t / tiles_x) * tile_h;              // in the band's image
    const int gy0 = ty0 + tile_row0 * tile_h;            // in the whole frame
    int lx, ly;
    tile_pixel(p, tile_w, tile_h, &lx, &ly);
    const int ix = tx0 + lx;
    const int iy = ty0 + ly;
    const bool inside = p < tile_w * tile_h && ix < width && iy < height;
    const float px = (float)ix + 0.5f;
    const float py = (float)(gy0 + ly) + 0.5f;
    const WarpRect rect = warp_rect(p, tile_w, tile_h, tx0, gy0);

    const int off = tile_offsets[t];
    const int cnt = tile_counts[t];

    float T = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f, d = 0.0f;
    int done_pairs = 0;
    int n_kept = 0, n_live = 0;

    for (int base = 0; base < cnt; base += BATCH) {
        const int nb = min(BATCH, cnt - base);
        // cooperative fused gather: nb rows and their extents
        stage_pairs(rows, ext, table, pair_gauss, off + base, nb);
        __syncthreads();

        for (int j0 = 0; j0 < nb; j0 += 32) {
            unsigned live = warp_live_pairs(ext, j0, nb, rect);
            if (COUNT) n_live += __popc(live);
            for (; live != 0u; live &= live - 1u) {
                const int j = j0 + __ffs(live) - 1;
                const float4 f0 = rows[j * ROW_F4 + 0];  // mx, my, A, B
                const float4 f1 = rows[j * ROW_F4 + 1];  // C, r, g, b
                const float4 f2 = rows[j * ROW_F4 + 2];  // depth, op, bound, pad
                float dx, dy;
                const float sigma = splat_sigma(px, py, f0, f1.x, &dx, &dy);
                if (splat_keep(sigma, f2.z)) {
                    const float alpha = fminf(splat_alpha_raw(f2.y, sigma), alpha_clamp);
                    composite_step(alpha, f1, f2.x, &T, &r, &g, &b, &d);
                    if (COUNT && inside) ++n_kept;
                }
            }
        }
        done_pairs = base + nb;

        // the barrier also guards `rows` against the next batch's loads;
        // pixels beyond the image edge count as saturated
        if (sat_check) {
            if (__syncthreads_and(!inside || T < trans_eps)) break;
        } else {
            __syncthreads();
        }
    }

    if (inside) {
        const size_t o = (size_t)iy * width + ix;
        out_rgbd[o] = make_float4(r, g, b, d);
        out_tfinal[o] = T;
    }
    if (walked != nullptr && p == 0) walked[t] = done_pairs;
    if (COUNT) add_counters(counters, t, n_kept, n_live);
}

// Launches on `stream`, allocates nothing, does not synchronise. Returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int raster_fwd_launch(
    const void* table, const void* pair_gauss, const void* tile_offsets,
    const void* tile_counts, void* out_rgbd, void* out_tfinal, void* walked,
    void* counters,
    int num_tiles, int tiles_x, int tile_w, int tile_h, int width, int height,
    int tile_row0, float alpha_clamp, float trans_eps, int sat_check, void* stream)
{
    if (num_tiles > 0) {
        auto kernel = counters != nullptr ? raster_fwd_kernel<true> : raster_fwd_kernel<false>;
        const int threads = (tile_w * tile_h + 31) & ~31;  // whole warps
        kernel<<<num_tiles, threads, 0, (cudaStream_t)stream>>>(
            (const float4*)table, (const int*)pair_gauss, (const int*)tile_offsets,
            (const int*)tile_counts, (float4*)out_rgbd, (float*)out_tfinal,
            (int*)walked, (int*)counters, tiles_x, tile_w, tile_h, width, height,
            tile_row0, alpha_clamp, trans_eps, sat_check);
    }
    return (int)cudaGetLastError();
}
