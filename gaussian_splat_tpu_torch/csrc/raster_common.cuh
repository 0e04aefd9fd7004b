// Shared by raster_fwd.cu and raster_bwd.cu: the per-(pixel, splat) alpha code
// and the fused row gather. The backward kernel must take every keep decision,
// and round every alpha and transmittance, exactly as the forward kernel did,
// so both include THIS code; every operation is spelled with an explicit
// rounding intrinsic so that the compiler cannot contract the two copies
// differently. (_build.py hashes this header into both libraries' names.)
//
// table row: [mx, my, A, B | C, r, g, b | depth, op, bound, pad]

#pragma once

#include <cuda_runtime.h>

#define ROW_F4 3  // float4 loads per table row (12 floats)

// Cooperative gather of `nb` rows of the pair list [first, first + nb) into
// shared memory: three float4 per row, straight from the per-splat table.
__device__ __forceinline__ void gather_rows(
    float4* __restrict__ rows, const float4* __restrict__ table,
    const int* __restrict__ pair_gauss, int first, int nb)
{
    for (int i = threadIdx.x; i < nb * ROW_F4; i += blockDim.x) {
        const int j = i / ROW_F4;
        const int k = i - j * ROW_F4;
        const int gi = pair_gauss[first + j];
        rows[i] = table[(size_t)gi * ROW_F4 + k];
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
