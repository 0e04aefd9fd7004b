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
// The ten per-pair sums are reduced over the block without float atomics:
// inside each warp, then one slot per (pair, warp) in shared memory, then a
// fixed-order sum over the warps. Every row of the output is written exactly
// once and every addition has a fixed place, so the result is bitwise
// reproducible.
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
// 44 for the gradient and its ten sums): 13.1 GFLOP, 0.20 ms at 67 TFLOP/s.
// So it is bound by operations, not by bytes; and what it really pays for no
// flop count shows: the (warp, pair)s that end in nothing (85 % of the steps
// fail the keep test) and the reduction of ten sums per live (warp, pair).
//
// What the design does about it:
//   * warps of 8x4 pixels and a per-warp extent test before the row is loaded
//     (raster_common.cuh, shared with raster_fwd): a warp tests 32 staged
//     pairs at once, one per lane, and walks only the pairs it may touch;
//   * a transposing butterfly for the ten sums: at each of the five steps a
//     lane keeps half of the values it still holds and sends the other half to
//     its partner, adding what it receives (10 -> 5 -> 3 -> 2 -> 1 -> 1 values
//     held, 5 + 3 + 2 + 1 + 1 = 12 shuffles where ten xor butterflies take 50).
//     Ten known lanes end up with one complete warp sum each;
//   * no zero-writes: a warp that reduces sets its bit in the pair's mask of
//     live warps (atomicOr on a shared word; an OR commutes, so the mask is
//     deterministic), and the cross-warp sum adds only the slots whose bit is
//     set, in ascending warp order. A pair with an empty mask gets its zero row
//     without a read of `part`.
// Measured with chip_smoke.py on an NVIDIA H100 80GB HBM3 (700.00 W limit), 1M
// splats / 1920x1080: 1.72 ms a launch (11 % of that bound's rate) where the
// kernel with 32x1 warps, 50 shuffles and zero-writes took 4.02 ms in the
// same call; 33 % of the (warp, pair)s pass the cull; 51 registers, 13.5 KB
// static + 80 KB dynamic shared memory, no spills, two 512-thread blocks per
// SM. What is left is the instruction count of a live (warp, pair), about a
// third of it the butterfly (PERF.md, sections 6 and 7).
//
// `counters` (optional, may be null; (T, 2) int32, zeroed by the caller)
// receives per tile the kept steps inside the image and the (warp, pair)s
// that were not culled, as in raster_fwd.
//
// Bands: `tile_row0` as in raster_fwd (the TPU kernel's `trow0`): global
// pixel centres and cull rectangles, band-local image rows.

#include "raster_common.cuh"

#define MAX_BATCH 128    // pairs per shared-memory batch (the launcher picks <= this)
#define NSUM 10          // per-pair sums: S1 Sx Sy Sxx Sxy Syy, d r g b depth

// One step of the transposing butterfly over the lane bit `m`: of the 2*H
// values in v (v[2*H-1] may be a zero pad) a lane with the bit clear keeps
// v[0..H), a lane with the bit set keeps v[H..2H); each sends the other half
// to its partner and adds what it receives into out[0..H).
template <int H>
__device__ __forceinline__ void butterfly_halve(const float* v, float* out, int m, bool hi)
{
#pragma unroll
    for (int i = 0; i < H; ++i) {
        const float keep = hi ? v[i + H] : v[i];
        const float send = hi ? v[i] : v[i + H];
        out[i] = keep + __shfl_xor_sync(FULL_MASK, send, m);
    }
}

// Sum each of s[0..10) over the warp in 12 shuffles. Returns the warp sum of
// s[c] on the lane with warp_sum_column(lane) == c, and garbage elsewhere.
__device__ __forceinline__ float warp_sum_ten(const float* s, int lane)
{
    float a[6], b[4], c[2], d[1];
    butterfly_halve<5>(s, a, 16, lane & 16);   // 10 -> 5
    a[5] = 0.0f;
    butterfly_halve<3>(a, b, 8, lane & 8);     // 5 (+1 pad) -> 3
    b[3] = 0.0f;
    butterfly_halve<2>(b, c, 4, lane & 4);     // 3 (+1 pad) -> 2
    butterfly_halve<1>(c, d, 2, lane & 2);     // 2 -> 1
    return d[0] + __shfl_xor_sync(FULL_MASK, d[0], 1);
}

// Which of the ten columns a lane holds after warp_sum_ten, or -1: lane bit 4
// chose the half of ten, bit 3 the half of five (3 + 2), bits 2 and 1 the
// rest; the pads fall on the lanes that return -1. Lanes with bit 0 set hold
// copies.
__device__ __forceinline__ int warp_sum_column(int lane)
{
    const int b3 = (lane >> 3) & 1, b2 = (lane >> 2) & 1, b1 = (lane >> 1) & 1;
    const int in_three = 2 * b2 + b1;          // index in a group of 3 (+1 pad) or 2 (+2 pads)
    if ((lane & 1) || in_three >= (b3 ? 2 : 3)) return -1;
    return ((lane >> 4) & 1) * 5 + b3 * 3 + in_three;
}

template <bool COUNT>
__global__ void __launch_bounds__(1024) raster_bwd_kernel(
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
    int* __restrict__ counters,            // (T, 2), only read when COUNT
    int tiles_x, int tile_w, int tile_h, int width, int height, int tile_row0,
    float alpha_clamp, int batch)
{
    __shared__ float4 rows[MAX_BATCH * ROW_F4];
    __shared__ float4 ext[MAX_BATCH];
    __shared__ float sums[MAX_BATCH * NSUM];
    __shared__ unsigned live_warps[MAX_BATCH];  // per pair: bit w = warp w reduced
    extern __shared__ float part[];             // (batch, nwarps, NSUM)

    const int t = blockIdx.x;
    const int p = threadIdx.x;             // blockDim.x = tile pixels rounded up to 32
    const int lane = p & 31;
    const int warp = p >> 5;
    const int nwarps = blockDim.x >> 5;
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
    const int column = warp_sum_column(lane);

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
    int n_kept = 0, n_live = 0;

    for (int base = 0; base < nwalk; base += batch) {
        const int nb = min(batch, nwalk - base);
        stage_pairs(rows, ext, table, pair_gauss, off + base, nb);
        for (int j = p; j < nb; j += blockDim.x) live_warps[j] = 0u;
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
                const bool kept = inside && splat_keep(sigma, f2.z);
                if (__ballot_sync(FULL_MASK, kept) == 0u) continue;

                float s[NSUM];
#pragma unroll
                for (int c = 0; c < NSUM; ++c) s[c] = 0.0f;
                if (kept) {
                    if (COUNT) ++n_kept;
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
                const float total = warp_sum_ten(s, lane);
                if (column >= 0) part[((size_t)j * nwarps + warp) * NSUM + column] = total;
                if (lane == 0) atomicOr(&live_warps[j], 1u << warp);
            }
        }
        __syncthreads();

        // across the warps that reduced, in ascending warp order
        for (int o = p; o < nb * NSUM; o += blockDim.x) {
            const int j = o / NSUM;
            const int c = o - j * NSUM;
            const float* src = part + (size_t)j * nwarps * NSUM + c;
            float acc = 0.0f;
            for (unsigned m = live_warps[j]; m != 0u; m &= m - 1u)
                acc += src[(__ffs(m) - 1) * NSUM];
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
        __syncthreads();  // the staged batch, sums and part are rewritten by the next batch
    }

    // pairs of the segment that the forward did not walk: zero rows
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4* rest_rows = out_rows + (size_t)(off + nwalk) * ROW_F4;
    for (int i = p; i < (cnt - nwalk) * ROW_F4; i += blockDim.x) rest_rows[i] = zero;
    if (COUNT) add_counters(counters, t, n_kept, n_live);
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

// Launches on `stream`, allocates nothing, does not synchronise. Returns the
// first CUDA error of the attribute call and the launches (0 = success).
extern "C" int raster_bwd_launch(
    const void* table, const void* pair_gauss, const void* tile_offsets,
    const void* tile_counts, const void* walked, const void* rgbd,
    const void* t_final, const void* d_rgbd, const void* d_tfinal, void* out_rows,
    void* counters,
    int num_rows, int num_tiles, int tiles_x, int tile_w, int tile_h,
    int width, int height, int tile_row0, float alpha_clamp, void* stream)
{
    const cudaStream_t s = (cudaStream_t)stream;
    const int threads = (tile_w * tile_h + 31) & ~31;
    const int nwarps = threads >> 5;
    // one 40-byte slot per (pair, warp): 80 KB of dynamic shared memory for
    // the default 16 warps, which leaves room for two blocks on an SM
    const int batch = nwarps <= 16 ? MAX_BATCH : MAX_BATCH / 2;
    const size_t smem = (size_t)batch * nwarps * NSUM * sizeof(float);
    if (num_tiles > 0) {
        auto kernel = counters != nullptr ? raster_bwd_kernel<true> : raster_bwd_kernel<false>;
        int err = (int)cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != 0) return err;
        kernel<<<num_tiles, threads, smem, s>>>(
            (const float4*)table, (const int*)pair_gauss, (const int*)tile_offsets,
            (const int*)tile_counts, (const int*)walked, (const float4*)rgbd,
            (const float*)t_final, (const float4*)d_rgbd, (const float*)d_tfinal,
            (float4*)out_rows, (int*)counters, tiles_x, tile_w, tile_h, width, height,
            tile_row0, alpha_clamp, batch);
        err = (int)cudaGetLastError();
        if (err != 0) return err;
    }
    if (num_rows > 0) {
        raster_bwd_zero_tail_kernel<<<256, 256, 0, s>>>(
            (float4*)out_rows, (const int*)tile_offsets, (const int*)tile_counts,
            num_tiles, num_rows);
    }
    return (int)cudaGetLastError();
}
