// raster_bwd — backward tile rasterizer for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel gaussian_splat_tpu/ops/pallas_raster.py::_bwd_kernel
// (body _bwd_one_tile, launched by _raster_backward). What it computes, per
// tile: one front-to-back pass over the tile's pair segment that recomputes
// alpha exactly as raster_fwd did, and from the cotangents gC of r,g,b,depth
// and gT of T_final, and the saved forward results C_total and T_final, the
// gradient of every PAIR's table row. Per pixel p and pair i:
//     v_i   = gC . c_i                       (c = r,g,b,depth of the splat)
//     w_i   = alpha_i * T_i                  (T_i transmittance before i)
//     rest  = gC . (C_total - C_upto_i) + gT * T_final
//     d_alpha_i = v_i * T_i - rest / (1 - alpha_i)
//     d_alpha_i = 0 unless keep_i and alpha_raw_i < alpha_clamp
//     d_sigma_i = -d_alpha_i * alpha_raw_i
// and per pair, summed over the tile's pixels:
//     d[r,g,b,depth] = sum gC * w_i          d op = -sum d_sigma / op
//     d mx = -(A Sx + B Sy)                  d my = -(C Sy + B Sx)
//     d A  = Sxx / 2     d B = Sxy     d C = Syy / 2
// with the moments S. = sum d_sigma * {dx, dy, dx^2, dx dy, dy^2} about the
// splat's own centre (dx = px - mx), so nothing large cancels.
//
// Design (one thread block per tile, one thread per pixel, as raster_fwd):
// nothing of the TPU kernel's layout is carried over — no triangular-matmul
// prefixes, no moment matmul, no aligned supersets with a shared head, no
// bf16 packing. Each thread keeps T and the four running colour sums in
// registers and steps them with the SAME code as the forward
// (raster_common.cuh), so C_upto_i is bit-identical to the forward's partial
// sum and `C_total - C_upto_i` is exactly 0 after the last contributing pair:
// the suffix sum cancels against the rounding the forward really produced.
// The ten per-pair sums are reduced over the block without atomics: xor
// shuffles inside each warp, one slot per (pair, warp) in shared memory, then
// a fixed-order sum over the warps. A warp whose 32 pixels all fail a pair's
// keep test writes zeros and skips the shuffles (__ballot_sync). Every row of
// the output is written exactly once, so the result is bitwise reproducible.
//
// The early exit. With sat_check the forward left a tile at batch granularity
// and saved T_final at that point; `walked` (pairs walked per tile, written
// by raster_fwd) is this kernel's segment length, and the pairs of the
// segment it did not walk get zero rows. Rows past the last tile's segment
// (padding up to the pair budget) are zeroed by a second small kernel of this
// file. Pixels beyond the image edge carry no cotangent and never pass `kept`.
//
// Bound on this card. At 1M splats / 1920x1080 it reads the 48 MB table, the
// pair list, four images (83 MB) and writes 48 B per pair: under 0.1 ms at
// 3.35 TB/s. Against that stand the (pixel, pair) steps: 9 flops each for
// sigma as in the forward, and 58 more on a kept step (the forward's 14, and
// 44 for the gradient and its ten sums); and the block
// reduction, 50 shuffles per (warp, pair) that is not skipped, which no flop
// count shows. So it is bound by operations, not by bytes.
// Measured with chip_smoke.py on an NVIDIA H100 80GB HBM3 (700 W limit) at that
// shape: about 3.9 ms a launch against a bound of 0.20 ms (13.1 GFLOP at
// 67 TFLOP/s), 51 registers, 5.6 KB static + 40 KB dynamic shared memory, no
// spills. This first version does nothing cleverer about the reduction than
// skipping all-fail warps; a later change could reduce the ten values with a
// transposing butterfly (about 12 shuffles instead of 50).

#include "raster_common.cuh"

#define MAX_BATCH 64     // pairs per shared-memory batch (the launcher picks <= this)
#define NSUM 10          // per-pair sums: S1 Sx Sy Sxx Sxy Syy, d r g b depth

extern "C" __global__ void __launch_bounds__(1024) raster_bwd_kernel(
    const float4* __restrict__ table,      // (N, 3) float4
    const int* __restrict__ pair_gauss,    // (B,)
    const int* __restrict__ tile_offsets,  // (T,)
    const int* __restrict__ tile_counts,   // (T,)
    const int* __restrict__ walked,        // (T,) pairs the forward walked, or null
    const float4* __restrict__ rgbd,       // (H, W) float4: forward r, g, b, depth
    const float* __restrict__ t_final,     // (H, W) forward T_final
    const float4* __restrict__ d_rgbd,     // (H, W) float4 cotangent
    const float* __restrict__ d_tfinal,    // (H, W) cotangent
    float4* __restrict__ out_rows,         // (B, 3) float4: d[mx,my,A,B | C,r,g,b | depth,op,0,0]
    int tiles_x, int tile_w, int tile_h, int width, int height,
    float alpha_clamp, int batch)
{
    __shared__ float4 rows[MAX_BATCH * ROW_F4];
    __shared__ float sums[MAX_BATCH * NSUM];
    extern __shared__ float part[];        // (batch, nwarps, NSUM)

    const int t = blockIdx.x;
    const int p = threadIdx.x;             // blockDim.x = tile pixels rounded up to 32
    const int lane = p & 31;
    const int warp = p >> 5;
    const int nwarps = blockDim.x >> 5;
    const int ix = (t % tiles_x) * tile_w + p % tile_w;
    const int iy = (t / tiles_x) * tile_h + p / tile_w;
    const bool inside = p < tile_w * tile_h && ix < width && iy < height;
    const float px = (float)ix + 0.5f;
    const float py = (float)iy + 0.5f;

    float4 gC = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 Ctot = gC;
    float tail = 0.0f;                     // gT * T_final
    if (inside) {
        const size_t o = (size_t)iy * width + ix;
        gC = d_rgbd[o];
        Ctot = rgbd[o];
        tail = d_tfinal[o] * t_final[o];
    }

    const int off = tile_offsets[t];
    const int cnt = tile_counts[t];
    const int nwalk = walked != nullptr ? min(walked[t], cnt) : cnt;

    float T = 1.0f, ar = 0.0f, ag = 0.0f, ab = 0.0f, ad = 0.0f;

    for (int base = 0; base < nwalk; base += batch) {
        const int nb = min(batch, nwalk - base);
        gather_rows(rows, table, pair_gauss, off + base, nb);
        __syncthreads();

        for (int j = 0; j < nb; ++j) {
            const float4 f0 = rows[j * ROW_F4 + 0];  // mx, my, A, B
            const float4 f1 = rows[j * ROW_F4 + 1];  // C, r, g, b
            const float4 f2 = rows[j * ROW_F4 + 2];  // depth, op, bound, pad
            float dx, dy;
            const float sigma = splat_sigma(px, py, f0, f1.x, &dx, &dy);
            const bool kept = inside && splat_keep(sigma, f2.z);
            float* dst = part + ((size_t)j * nwarps + warp) * NSUM;
            if (__ballot_sync(0xffffffffu, kept) == 0u) {
                if (lane == 0) {
#pragma unroll
                    for (int c = 0; c < NSUM; ++c) dst[c] = 0.0f;
                }
                continue;
            }

            float s[NSUM];
#pragma unroll
            for (int c = 0; c < NSUM; ++c) s[c] = 0.0f;
            if (kept) {
                const float alpha_raw = splat_alpha_raw(f2.y, sigma);
                const float alpha = fminf(alpha_raw, alpha_clamp);
                const float t_before = T;
                const float w = composite_step(alpha, f1, f2.x, &T, &ar, &ag, &ab, &ad);
                const float rest = gC.x * (Ctot.x - ar) + gC.y * (Ctot.y - ag)
                                 + gC.z * (Ctot.z - ab) + gC.w * (Ctot.w - ad) + tail;
                const float v = gC.x * f1.y + gC.y * f1.z + gC.z * f1.w + gC.w * f2.x;
                const float da = v * t_before - rest / (1.0f - alpha);
                const float ds = alpha_raw < alpha_clamp ? -da * alpha_raw : 0.0f;
                s[0] = ds;
                s[1] = ds * dx;
                s[2] = ds * dy;
                s[3] = s[1] * dx;
                s[4] = s[1] * dy;
                s[5] = s[2] * dy;
                s[6] = gC.x * w;
                s[7] = gC.y * w;
                s[8] = gC.z * w;
                s[9] = gC.w * w;
            }
#pragma unroll
            for (int c = 0; c < NSUM; ++c) {
#pragma unroll
                for (int m = 16; m > 0; m >>= 1)
                    s[c] += __shfl_xor_sync(0xffffffffu, s[c], m);
            }
            if (lane == 0) {
#pragma unroll
                for (int c = 0; c < NSUM; ++c) dst[c] = s[c];
            }
        }
        __syncthreads();

        // across the warps, in a fixed order
        for (int o = p; o < nb * NSUM; o += blockDim.x) {
            const int j = o / NSUM;
            const int c = o - j * NSUM;
            const float* src = part + (size_t)j * nwarps * NSUM + c;
            float acc = 0.0f;
            for (int w = 0; w < nwarps; ++w) acc += src[w * NSUM];
            sums[o] = acc;
        }
        __syncthreads();

        // one thread per pair: moments -> the row's gradient, written once
        for (int j = p; j < nb; j += blockDim.x) {
            const float4 f0 = rows[j * ROW_F4 + 0];
            const float C = rows[j * ROW_F4 + 1].x;
            const float op = rows[j * ROW_F4 + 2].y;
            const float* m = sums + j * NSUM;
            const float A = f0.z, B = f0.w;
            float4* out = out_rows + (size_t)(off + base + j) * ROW_F4;
            out[0] = make_float4(-(A * m[1] + B * m[2]), -(C * m[2] + B * m[1]),
                                 0.5f * m[3], m[4]);
            out[1] = make_float4(0.5f * m[5], m[6], m[7], m[8]);
            out[2] = make_float4(m[9], op > 0.0f ? -m[0] / op : 0.0f, 0.0f, 0.0f);
        }
        __syncthreads();  // rows, sums and part are rewritten by the next batch
    }

    // pairs of the segment that the forward did not walk: zero rows
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4* rest_rows = out_rows + (size_t)(off + nwalk) * ROW_F4;
    for (int i = p; i < (cnt - nwalk) * ROW_F4; i += blockDim.x) rest_rows[i] = zero;
}

// Rows past the last tile's segment (padding up to the pair budget): zeros.
extern "C" __global__ void raster_bwd_zero_tail_kernel(
    float4* __restrict__ out_rows, const int* __restrict__ tile_offsets,
    const int* __restrict__ tile_counts, int num_tiles, int num_rows)
{
    const int total = num_tiles > 0
        ? tile_offsets[num_tiles - 1] + tile_counts[num_tiles - 1] : 0;
    const size_t first = (size_t)total * ROW_F4;
    const size_t n = (size_t)num_rows * ROW_F4;
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (size_t i = first + (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (size_t)gridDim.x * blockDim.x)
        out_rows[i] = zero;
}

// Launches on `stream`, allocates nothing, does not synchronise. Returns
// cudaGetLastError() after the launches (0 = success).
extern "C" int raster_bwd_launch(
    const void* table, const void* pair_gauss, const void* tile_offsets,
    const void* tile_counts, const void* walked, const void* rgbd,
    const void* t_final, const void* d_rgbd, const void* d_tfinal, void* out_rows,
    int num_rows, int num_tiles, int tiles_x, int tile_w, int tile_h,
    int width, int height, float alpha_clamp, void* stream)
{
    const cudaStream_t s = (cudaStream_t)stream;
    const int threads = (tile_w * tile_h + 31) & ~31;
    const int nwarps = threads >> 5;
    const int batch = nwarps <= 16 ? MAX_BATCH : MAX_BATCH / 2;
    const size_t smem = (size_t)batch * nwarps * NSUM * sizeof(float);
    if (num_tiles > 0) {
        raster_bwd_kernel<<<num_tiles, threads, smem, s>>>(
            (const float4*)table, (const int*)pair_gauss, (const int*)tile_offsets,
            (const int*)tile_counts, (const int*)walked, (const float4*)rgbd,
            (const float*)t_final, (const float4*)d_rgbd, (const float*)d_tfinal,
            (float4*)out_rows, tiles_x, tile_w, tile_h, width, height,
            alpha_clamp, batch);
        const int err = (int)cudaGetLastError();
        if (err != 0) return err;
    }
    if (num_rows > 0) {
        raster_bwd_zero_tail_kernel<<<256, 256, 0, s>>>(
            (float4*)out_rows, (const int*)tile_offsets, (const int*)tile_counts,
            num_tiles, num_rows);
    }
    return (int)cudaGetLastError();
}
