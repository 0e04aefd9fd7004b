// projection — EWA projection of every splat to the screen and its unit view
// direction, forward (proj_fwd) and backward (proj_bwd), for Hopper
// (sm_90a), plain C interface.
//
// Replaces no Pallas kernel: on the TPU, XLA fused
// gaussian_splat_tpu/ops/projection.py::project_gaussians, view_directions
// and their VJP into a few passes. On this card nothing fuses plain torch:
// the same stage as torch ops is ~300 elementwise launches forward and ~460
// backward, ~9 KB of memory traffic a row, and autograd keeps ~100
// intermediate tensors from the forward to the backward. The function (its
// plain versions: ops/projection.py::project_gaussians_torch with
// view_directions, and project_backward_torch), per row i:
//   view point   p = W·means[i] + t;  z > near, else culled (zs = 1)
//   covariance   Σview = (W·R(q̂))·S²·(W·R(q̂))ᵀ,  q̂ = q / max(|q|, 1e-8)
//   Jacobian     J = [[fx/zs, 0, −fx·tx/zs²], [0, fy/zs, −fy·ty/zs²]],
//                tx = min(max(x/zs, −lim_x), lim_x)·zs (ty alike)
//   2D           (a, b, c) = J·Σview·Jᵀ + dilation on the diagonal; the
//                conic, the compensation √(max(det_raw, 0) / max(det, 1e-12)),
//                the eigenvalue radius, the exact ellipse extents, the culls
//   direction    d = means[i] − centre, d / max(|d|, 1e-8)
// and the gradient of every float output back to means, quats, scales and
// (opacity-aware extents) opacities.
//
// The forward is bitwise the plain forward on this card: every multiply,
// add, divide and square root is one correctly rounded operation in the
// plain version's order (__fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn,
// which the compiler never contracts into a fused multiply-add), logf and
// ceilf are the functions torch's kernels call, minimum / maximum / clamp_min
// keep torch's NaN rules, and the two sums of squares keep the order of
// torch's reduction kernel over a last dimension of 4 or 3 (a warp-shuffle
// tree whose offsets halve: (q0² + q2²) + (q1² + q3²); and, two lanes with
// the odd element on the first, (d0² + d2²) + d1²).
// The camera centre is the plain version's own tensor (the wrapper's
// camera.position), read like the camera's other entries through a pointer:
// no value leaves the device. So radii, valid and extents are identical and
// binning makes the same pairs.
//
// The backward recomputes the forward's intermediates in registers from the
// saved inputs (the same exact arithmetic, so every mask and every kink
// agrees with the forward; only the stages that its cotangents reach: in a
// train step, neither the compensation nor the extents), then walks autograd's graph of the plain
// version in reverse: clamp_min and where pass the gradient where the value
// was kept (x >= lo at equality), minimum / maximum split it evenly at a
// tie, a square root's gradient is g / (2·result) (NaN at 0 / 0, as
// autograd gives it). A cotangent pointer that is null is an output that
// takes no gradient, and a branch that no given cotangent reaches is not
// walked, as in autograd. grad_means is written once, the projection's and
// the direction's contributions summed in registers.
//
// Bound on this card: bytes. A row is ~44 bytes of inputs and ~65 of outputs
// forward against ~280 operations, ~120 bytes and ~700 operations backward
// in a train step: far below the card's ~20 operations a byte. Design: one
// thread a row, the row's inputs read once, every intermediate in registers,
// each output written once; the camera (~25 floats) is read by every thread
// from the same addresses (one transaction a warp, from L1). No atomics, no
// order that depends on scheduling: two runs give the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define ROWS 256  // threads a block, one a row

// One correctly rounded operation each, never contracted.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }

// torch.clamp_min(v, lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo)
{
    return v != v ? v : fmaxf(v, lo);
}
// torch.maximum / torch.minimum: a NaN operand wins
__device__ __forceinline__ float tmax(float a, float b)
{
    return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b)
{
    return a != a ? a : (b != b ? b : fminf(a, b));
}

struct Cam {
    float W[9], t[3], fx, fy, cx, cy, centre[3];
};

__device__ __forceinline__ Cam load_cam(const float* __restrict__ viewmat,
                                        const float* __restrict__ fx,
                                        const float* __restrict__ fy,
                                        const float* __restrict__ cx,
                                        const float* __restrict__ cy,
                                        const float* __restrict__ centre)
{
    Cam c;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) c.W[3 * i + j] = __ldg(viewmat + 4 * i + j);
        c.t[i] = __ldg(viewmat + 4 * i + 3);
        c.centre[i] = __ldg(centre + i);
    }
    c.fx = __ldg(fx);
    c.fy = __ldg(fy);
    c.cx = __ldg(cx);
    c.cy = __ldg(cy);
    return c;
}

struct Settings {
    int width, height, aware;
    float near_plane, dilation, sigma_cap, log_skip;
};

// Every intermediate of one row's forward.
struct Row {
    float m[3], q[4], s[3], op;
    float qnorm, qn[4], U[9], s2[3];
    float sv[6];  // s00 s01 s02 s11 s12 s22
    float x, y, z, zs;
    bool in_front;
    float lim_x, lim_y, ux, uy, vx, vy, wx, wy, tx, ty;
    float inv_z, inv_z2, j00, j02, j11, j12;
    float a0, b, c0, det_raw, a, c, det, comp_den, comp_sq, comp;
    bool det_ok;
    float inv_det, sigma_max, sigma_pos, op_floor, log_op, rx, ry, mean_x, mean_y;
    int radius;
    bool valid;
};

// The plain forward's arithmetic, operation for operation, in four stages:
// the view point (every output needs it), the 2D covariance and its conic,
// the compensation, and the extents with the culls. The backward runs only
// the stages that the cotangents it is given reach.
__device__ __forceinline__ void view_stage(const Cam& C, const Settings& P, Row& R)
{
    const float* W = C.W;
    // view transform + near cull
    R.x = add(add(add(mul(R.m[0], W[0]), mul(R.m[1], W[1])), mul(R.m[2], W[2])), C.t[0]);
    R.y = add(add(add(mul(R.m[0], W[3]), mul(R.m[1], W[4])), mul(R.m[2], W[5])), C.t[1]);
    R.z = add(add(add(mul(R.m[0], W[6]), mul(R.m[1], W[7])), mul(R.m[2], W[8])), C.t[2]);
    R.in_front = R.z > P.near_plane;
    R.zs = R.in_front ? R.z : 1.0f;
    R.inv_z = dvd(1.0f, R.zs);
}

__device__ __forceinline__ void cov_stage(const Cam& C, const Settings& P, Row& R)
{
    const float* W = C.W;
    // rotation of the unit quaternion
    const float* q = R.q;
    R.qnorm = sqrt_rn(add(add(mul(q[0], q[0]), mul(q[2], q[2])),
                          add(mul(q[1], q[1]), mul(q[3], q[3]))));
    const float qc = clamp_min(R.qnorm, 1e-8f);
#pragma unroll
    for (int k = 0; k < 4; ++k) R.qn[k] = dvd(q[k], qc);
    const float w = R.qn[0], x = R.qn[1], y = R.qn[2], z = R.qn[3];
    float r[9];
    r[0] = sub(1.0f, mul(2.0f, add(mul(y, y), mul(z, z))));
    r[1] = mul(2.0f, sub(mul(x, y), mul(w, z)));
    r[2] = mul(2.0f, add(mul(x, z), mul(w, y)));
    r[3] = mul(2.0f, add(mul(x, y), mul(w, z)));
    r[4] = sub(1.0f, mul(2.0f, add(mul(x, x), mul(z, z))));
    r[5] = mul(2.0f, sub(mul(y, z), mul(w, x)));
    r[6] = mul(2.0f, sub(mul(x, z), mul(w, y)));
    r[7] = mul(2.0f, add(mul(y, z), mul(w, x)));
    r[8] = sub(1.0f, mul(2.0f, add(mul(x, x), mul(y, y))));

    // Σview = U·S²·Uᵀ, U = W·R
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j)
            R.U[3 * i + j] = add(add(mul(W[3 * i], r[j]), mul(W[3 * i + 1], r[3 + j])),
                                 mul(W[3 * i + 2], r[6 + j]));
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) R.s2[k] = mul(R.s[k], R.s[k]);
    const int pairs[6][2] = {{0, 0}, {0, 1}, {0, 2}, {1, 1}, {1, 2}, {2, 2}};
#pragma unroll
    for (int p = 0; p < 6; ++p) {
        const float* Ui = R.U + 3 * pairs[p][0];
        const float* Uj = R.U + 3 * pairs[p][1];
        R.sv[p] = add(add(mul(mul(Ui[0], Uj[0]), R.s2[0]), mul(mul(Ui[1], Uj[1]), R.s2[1])),
                      mul(mul(Ui[2], Uj[2]), R.s2[2]));
    }

    // perspective Jacobian with frustum-clamped inputs
    R.lim_x = mul(mul(dvd(1.0f, C.fx), 0.5f * (float)P.width), 1.3f);
    R.lim_y = mul(mul(dvd(1.0f, C.fy), 0.5f * (float)P.height), 1.3f);
    R.ux = dvd(R.x, R.zs);
    R.uy = dvd(R.y, R.zs);
    R.vx = tmax(R.ux, -R.lim_x);
    R.vy = tmax(R.uy, -R.lim_y);
    R.wx = tmin(R.vx, R.lim_x);
    R.wy = tmin(R.vy, R.lim_y);
    R.tx = mul(R.wx, R.zs);
    R.ty = mul(R.wy, R.zs);
    R.inv_z2 = mul(R.inv_z, R.inv_z);
    R.j00 = mul(C.fx, R.inv_z);
    R.j02 = mul(mul(-C.fx, R.tx), R.inv_z2);
    R.j11 = mul(C.fy, R.inv_z);
    R.j12 = mul(mul(-C.fy, R.ty), R.inv_z2);

    // cov2d = J·Σview·Jᵀ
    const float s00 = R.sv[0], s01 = R.sv[1], s02 = R.sv[2], s11 = R.sv[3], s12 = R.sv[4],
                s22 = R.sv[5];
    const float j00 = R.j00, j02 = R.j02, j11 = R.j11, j12 = R.j12;
    R.a0 = add(mul(j00, add(mul(j00, s00), mul(j02, s02))),
               mul(j02, add(mul(j00, s02), mul(j02, s22))));
    R.b = add(mul(j00, add(mul(j11, s01), mul(j12, s02))),
              mul(j02, add(mul(j11, s12), mul(j12, s22))));
    R.c0 = add(mul(j11, add(mul(j11, s11), mul(j12, s12))),
               mul(j12, add(mul(j11, s12), mul(j12, s22))));
    R.a = add(R.a0, P.dilation);
    R.c = add(R.c0, P.dilation);

    // conic
    R.det = sub(mul(R.a, R.c), mul(R.b, R.b));
    R.det_ok = R.det > 1e-10f;
    R.inv_det = dvd(1.0f, R.det_ok ? R.det : 1.0f);
}

__device__ __forceinline__ void comp_stage(Row& R)
{
    R.det_raw = sub(mul(R.a0, R.c0), mul(R.b, R.b));
    R.comp_den = clamp_min(R.det, 1e-12f);
    R.comp_sq = dvd(clamp_min(R.det_raw, 0.0f), R.comp_den);
    R.comp = sqrt_rn(R.comp_sq);
}

__device__ __forceinline__ void extent_stage(const Cam& C, const Settings& P, Row& R)
{
    // closed-form symmetric 2×2 eigenvalues
    const float det_safe = R.det_ok ? R.det : 1.0f;
    const float mid = mul(0.5f, add(R.a, R.c));
    const float disc = sqrt_rn(clamp_min(sub(mul(mid, mid), det_safe), 0.1f));
    const float lambda_max = add(mid, disc);
    R.sigma_max = P.sigma_cap;
    R.op_floor = R.log_op = 0.0f;
    if (P.aware) {
        R.op_floor = clamp_min(R.op, 1e-30f);
        R.log_op = sub(logf(R.op_floor), P.log_skip);
        R.sigma_max = tmin(P.sigma_cap, R.log_op);
    }
    R.sigma_pos = clamp_min(R.sigma_max, 0.0f);
    const float two_sp = mul(2.0f, R.sigma_pos);
    R.radius = (int)ceilf(sqrt_rn(mul(two_sp, clamp_min(lambda_max, 0.0f))));
    R.rx = sqrt_rn(mul(two_sp, clamp_min(R.a, 0.0f)));
    R.ry = sqrt_rn(mul(two_sp, clamp_min(R.c, 0.0f)));

    // projected centre and the frustum cull
    R.mean_x = add(mul(mul(C.fx, R.x), R.inv_z), C.cx);
    R.mean_y = add(mul(mul(C.fy, R.y), R.inv_z), C.cy);
    const bool on_screen = (add(R.mean_x, R.rx) > 0.0f) && (sub(R.mean_x, R.rx) < (float)P.width)
                           && (add(R.mean_y, R.ry) > 0.0f)
                           && (sub(R.mean_y, R.ry) < (float)P.height);
    R.valid = R.in_front && R.det_ok && on_screen && (R.radius > 0);
}

__device__ __forceinline__ void load_row(const float* __restrict__ means,
                                         const float* __restrict__ quats,
                                         const float* __restrict__ scales,
                                         const float* __restrict__ opacities, long long i,
                                         Row& R)
{
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        R.m[k] = __ldg(means + 3 * i + k);
        R.s[k] = __ldg(scales + 3 * i + k);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) R.q[k] = __ldg(quats + 4 * i + k);
    R.op = opacities ? __ldg(opacities + i) : 0.0f;
}

// d = means − centre, |d|, d / max(|d|, 1e-8)
__device__ __forceinline__ float direction(const Cam& C, const float* m, float* d, float* unit)
{
#pragma unroll
    for (int k = 0; k < 3; ++k) d[k] = sub(m[k], C.centre[k]);
    const float norm = sqrt_rn(add(add(mul(d[0], d[0]), mul(d[2], d[2])), mul(d[1], d[1])));
    const float nc = clamp_min(norm, 1e-8f);
#pragma unroll
    for (int k = 0; k < 3; ++k) unit[k] = dvd(d[k], nc);
    return norm;
}

__global__ void __launch_bounds__(ROWS) proj_fwd_kernel(
    const float* __restrict__ means, const float* __restrict__ quats,
    const float* __restrict__ scales, const float* __restrict__ opacities,
    const float* __restrict__ viewmat, const float* __restrict__ fx,
    const float* __restrict__ fy, const float* __restrict__ cx, const float* __restrict__ cy,
    const float* __restrict__ centre,
    float* __restrict__ means2d, float* __restrict__ conics, float* __restrict__ depths,
    int* __restrict__ radii, uint8_t* __restrict__ valid, float* __restrict__ cov2d,
    float* __restrict__ compensation, float* __restrict__ extents, float* __restrict__ dirs,
    int n, Settings P)
{
    const long long i = (long long)blockIdx.x * ROWS + threadIdx.x;
    if (i >= n) return;
    const Cam C = load_cam(viewmat, fx, fy, cx, cy, centre);
    Row R;
    load_row(means, quats, scales, opacities, i, R);
    view_stage(C, P, R);
    cov_stage(C, P, R);
    comp_stage(R);
    extent_stage(C, P, R);

    means2d[2 * i] = R.mean_x;
    means2d[2 * i + 1] = R.mean_y;
    conics[3 * i] = mul(R.c, R.inv_det);
    conics[3 * i + 1] = mul(-R.b, R.inv_det);
    conics[3 * i + 2] = mul(R.a, R.inv_det);
    depths[i] = R.z;
    radii[i] = R.valid ? R.radius : 0;
    valid[i] = R.valid;
    cov2d[3 * i] = R.a;
    cov2d[3 * i + 1] = R.b;
    cov2d[3 * i + 2] = R.c;
    compensation[i] = R.comp;
    extents[2 * i] = R.valid ? R.rx : 0.0f;
    extents[2 * i + 1] = R.valid ? R.ry : 0.0f;
    float d[3], unit[3];
    direction(C, R.m, d, unit);
#pragma unroll
    for (int k = 0; k < 3; ++k) dirs[3 * i + k] = unit[k];
}

// The gradient to v of v / max(√Σv², 1e-8), as autograd takes it (NaN at a
// zero v, where 0 / (2·0) appears).
template <int K>
__device__ __forceinline__ void unit_backward(const float* g_unit, const float* v,
                                              const float* unit, float norm, float* g_v)
{
    const float nc = clamp_min(norm, 1e-8f);
    float g_nc = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) g_nc -= g_unit[k] * (unit[k] / nc);
    const float g_ss = (norm >= 1e-8f ? g_nc : 0.0f) / (2.0f * norm);
#pragma unroll
    for (int k = 0; k < K; ++k) g_v[k] += g_unit[k] / nc + 2.0f * (g_ss * v[k]);
}

// gradient to x of torch.minimum(x, other) / torch.maximum(x, other)
__device__ __forceinline__ float min_grad(float g, float x, float other)
{
    return x == other ? 0.5f * g : (x > other ? 0.0f : g);
}
__device__ __forceinline__ float max_grad(float g, float x, float other)
{
    return x == other ? 0.5f * g : (x < other ? 0.0f : g);
}

// Four blocks an SM: at most 64 registers a thread (a few spill, to L1),
// twice the warps in flight that the 78 registers it would take allow, for
// the latency of its 20 loads a row (0.81 -> 0.66 ms at 11.2M rows on an
// H100 SXM at 700 W).
__global__ void __launch_bounds__(ROWS, 4) proj_bwd_kernel(
    const float* __restrict__ means, const float* __restrict__ quats,
    const float* __restrict__ scales, const float* __restrict__ opacities,
    const float* __restrict__ viewmat, const float* __restrict__ fx,
    const float* __restrict__ fy, const float* __restrict__ cx, const float* __restrict__ cy,
    const float* __restrict__ centre,
    const float* __restrict__ g_means2d, const float* __restrict__ g_conics,
    const float* __restrict__ g_depths, const float* __restrict__ g_cov2d,
    const float* __restrict__ g_compensation, const float* __restrict__ g_extents,
    const float* __restrict__ g_dirs,
    float* __restrict__ grad_means, float* __restrict__ grad_quats,
    float* __restrict__ grad_scales, float* __restrict__ grad_opacities, int n, Settings P)
{
    const long long i = (long long)blockIdx.x * ROWS + threadIdx.x;
    if (i >= n) return;
    const Cam C = load_cam(viewmat, fx, fy, cx, cy, centre);
    Row R;
    load_row(means, quats, scales, opacities, i, R);
    view_stage(C, P, R);
    const float fx_ = C.fx, fy_ = C.fy;

    float g_m[3] = {0.0f, 0.0f, 0.0f};
    float gx = 0.0f, gy = 0.0f, gz = 0.0f, g_zs = 0.0f, g_inv_z = 0.0f;

    if (g_dirs) {
        float d[3], unit[3], gd[3];
        const float norm = direction(C, R.m, d, unit);
#pragma unroll
        for (int k = 0; k < 3; ++k) gd[k] = __ldg(g_dirs + 3 * i + k);
        unit_backward<3>(gd, d, unit, norm, g_m);
    }
    if (g_depths) gz += __ldg(g_depths + i);
    if (g_means2d) {
        const float gmx = __ldg(g_means2d + 2 * i), gmy = __ldg(g_means2d + 2 * i + 1);
        gx += gmx * R.inv_z * fx_;
        gy += gmy * R.inv_z * fy_;
        g_inv_z += gmx * (fx_ * R.x) + gmy * (fy_ * R.y);
    }

    const bool has_cov = g_conics || g_cov2d || g_compensation || g_extents;
    if (has_cov) {
        cov_stage(C, P, R);
        if (g_compensation) comp_stage(R);
        if (g_extents) extent_stage(C, P, R);
        float g_a = 0.0f, g_b = 0.0f, g_c = 0.0f, g_det = 0.0f, g_a0 = 0.0f, g_c0 = 0.0f;
        if (g_cov2d) {
            g_a += __ldg(g_cov2d + 3 * i);
            g_b += __ldg(g_cov2d + 3 * i + 1);
            g_c += __ldg(g_cov2d + 3 * i + 2);
        }
        if (g_conics) {
            const float k0 = __ldg(g_conics + 3 * i), k1 = __ldg(g_conics + 3 * i + 1),
                        k2 = __ldg(g_conics + 3 * i + 2);
            g_c += k0 * R.inv_det;
            g_b -= k1 * R.inv_det;
            g_a += k2 * R.inv_det;
            const float g_inv_det = k0 * R.c + k1 * (-R.b) + k2 * R.a;
            if (R.det_ok) g_det += -g_inv_det * (R.inv_det * R.inv_det);
        }
        if (g_compensation) {
            const float g_sq = __ldg(g_compensation + i) / (2.0f * R.comp);
            const float g_num = g_sq / R.comp_den;
            const float g_den = -g_sq * (R.comp_sq / R.comp_den);
            const float g_det_raw = R.det_raw >= 0.0f ? g_num : 0.0f;
            if (R.det >= 1e-12f) g_det += g_den;
            g_a0 += g_det_raw * R.c0;
            g_c0 += g_det_raw * R.a0;
            g_b -= 2.0f * (g_det_raw * R.b);
        }
        if (g_extents) {
            const float two_sp = 2.0f * R.sigma_pos;
            const float gpx = (R.valid ? __ldg(g_extents + 2 * i) : 0.0f) / (2.0f * R.rx);
            const float gpy = (R.valid ? __ldg(g_extents + 2 * i + 1) : 0.0f) / (2.0f * R.ry);
            const float g_two_sp = gpx * clamp_min(R.a, 0.0f) + gpy * clamp_min(R.c, 0.0f);
            if (R.a >= 0.0f) g_a += gpx * two_sp;
            if (R.c >= 0.0f) g_c += gpy * two_sp;
            const float g_sigma_max = R.sigma_max >= 0.0f ? 2.0f * g_two_sp : 0.0f;
            if (P.aware) {
                const float g_log = min_grad(g_sigma_max, R.log_op, P.sigma_cap);
                grad_opacities[i] = R.op >= 1e-30f ? g_log / R.op_floor : 0.0f;
            }
        }
        g_a += g_det * R.c;
        g_c += g_det * R.a;
        g_b -= 2.0f * (g_det * R.b);
        g_a0 += g_a;
        g_c0 += g_c;

        // a0, b, c0 = J·Σview·Jᵀ
        const float j00 = R.j00, j02 = R.j02, j11 = R.j11, j12 = R.j12;
        const float s00 = R.sv[0], s01 = R.sv[1], s02 = R.sv[2], s11 = R.sv[3],
                    s12 = R.sv[4], s22 = R.sv[5];
        const float g_j00 = 2.0f * g_a0 * (j00 * s00 + j02 * s02) + g_b * (j11 * s01 + j12 * s02);
        const float g_j02 = 2.0f * g_a0 * (j00 * s02 + j02 * s22) + g_b * (j11 * s12 + j12 * s22);
        const float g_j11 = g_b * (j00 * s01 + j02 * s12) + 2.0f * g_c0 * (j11 * s11 + j12 * s12);
        const float g_j12 = g_b * (j00 * s02 + j02 * s22) + 2.0f * g_c0 * (j11 * s12 + j12 * s22);
        float g_s[6];
        g_s[0] = g_a0 * j00 * j00;
        g_s[1] = g_b * j00 * j11;
        g_s[2] = 2.0f * g_a0 * j00 * j02 + g_b * j00 * j12;
        g_s[3] = g_c0 * j11 * j11;
        g_s[4] = g_b * j02 * j11 + 2.0f * g_c0 * j11 * j12;
        g_s[5] = g_a0 * j02 * j02 + g_b * j02 * j12 + g_c0 * j12 * j12;

        // J from the clamped (tx, ty) and 1/z
        g_inv_z += g_j00 * fx_ + g_j11 * fy_;
        const float g_inv_z2 = g_j02 * (-fx_ * R.tx) + g_j12 * (-fy_ * R.ty);
        g_inv_z += 2.0f * g_inv_z2 * R.inv_z;
        {
            const float g_t = g_j02 * R.inv_z2 * (-fx_);
            const float g_u = max_grad(min_grad(g_t * R.zs, R.vx, R.lim_x), R.ux, -R.lim_x);
            gx += g_u / R.zs;
            g_zs += g_t * R.wx - g_u * (R.ux / R.zs);
        }
        {
            const float g_t = g_j12 * R.inv_z2 * (-fy_);
            const float g_u = max_grad(min_grad(g_t * R.zs, R.vy, R.lim_y), R.uy, -R.lim_y);
            gy += g_u / R.zs;
            g_zs += g_t * R.wy - g_u * (R.uy / R.zs);
        }

        // Σview = U·S²·Uᵀ (upper triangle), U = W·R
        const float G[3][3] = {{2.0f * g_s[0], g_s[1], g_s[2]},
                               {g_s[1], 2.0f * g_s[3], g_s[4]},
                               {g_s[2], g_s[4], 2.0f * g_s[5]}};
        float g_U[9];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
#pragma unroll
            for (int k = 0; k < 3; ++k)
                g_U[3 * a + k] = (G[a][0] * R.U[k] + G[a][1] * R.U[3 + k] + G[a][2] * R.U[6 + k])
                                 * R.s2[k];
        }
        if (grad_scales) {
            const int pairs[6][2] = {{0, 0}, {0, 1}, {0, 2}, {1, 1}, {1, 2}, {2, 2}};
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                float g_s2 = 0.0f;
#pragma unroll
                for (int p = 0; p < 6; ++p)
                    g_s2 += g_s[p] * R.U[3 * pairs[p][0] + k] * R.U[3 * pairs[p][1] + k];
                grad_scales[3 * i + k] = 2.0f * g_s2 * R.s[k];
            }
        }
        float g[9];  // to R's components, row-major
#pragma unroll
        for (int k = 0; k < 3; ++k) {
#pragma unroll
            for (int j = 0; j < 3; ++j)
                g[3 * k + j] = C.W[k] * g_U[j] + C.W[3 + k] * g_U[3 + j] + C.W[6 + k] * g_U[6 + j];
        }
        const float w = R.qn[0], x = R.qn[1], y = R.qn[2], z = R.qn[3];
        float g_qn[4];
        g_qn[0] = 2.0f * (-z * g[1] + y * g[2] + z * g[3] - x * g[5] - y * g[6] + x * g[7]);
        g_qn[1] = 2.0f * (y * g[1] + z * g[2] + y * g[3] - 2.0f * x * g[4] - w * g[5] + z * g[6]
                          + w * g[7] - 2.0f * x * g[8]);
        g_qn[2] = 2.0f * (-2.0f * y * g[0] + x * g[1] + w * g[2] + x * g[3] + z * g[5] - w * g[6]
                          + z * g[7] - 2.0f * y * g[8]);
        g_qn[3] = 2.0f * (-2.0f * z * g[0] - w * g[1] + x * g[2] + w * g[3] - 2.0f * z * g[4]
                          + y * g[5] + x * g[6] + y * g[7]);
        if (grad_quats) {
            float g_q[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            unit_backward<4>(g_qn, R.q, R.qn, R.qnorm, g_q);
#pragma unroll
            for (int k = 0; k < 4; ++k) grad_quats[4 * i + k] = g_q[k];
        }
    }

    // zs = where(in_front, z, 1), 1/zs; the view point p = W·m + t
    if (R.in_front) gz += g_zs - g_inv_z * (R.inv_z * R.inv_z);
#pragma unroll
    for (int k = 0; k < 3; ++k)
        grad_means[3 * i + k] = g_m[k] + (gx * C.W[k] + gy * C.W[3 + k] + gz * C.W[6 + k]);
}

// Both launch on `stream`, allocate nothing and do not synchronise. The
// wrapper checks every tensor; `opacities` is read only where `aware`, and
// a null cotangent or gradient pointer is an output that takes no gradient
// (grad_quats and grad_scales are null without a cotangent of the conics,
// cov2d, compensation or extents; grad_opacities without `aware` and one of
// the extents). Each returns cudaGetLastError() after the launch (0 =
// success).
extern "C" int proj_fwd_launch(
    const void* means, const void* quats, const void* scales, const void* opacities,
    const void* viewmat, const void* fx, const void* fy, const void* cx, const void* cy,
    const void* centre, void* means2d, void* conics, void* depths, void* radii, void* valid,
    void* cov2d, void* compensation, void* extents, void* dirs, int n, int width, int height,
    int aware, float near_plane, float dilation, float sigma_cap, float log_skip, void* stream)
{
    if (n > 0) {
        const Settings P{width, height, aware, near_plane, dilation, sigma_cap, log_skip};
        const unsigned blocks = (unsigned)((n + ROWS - 1) / ROWS);
        proj_fwd_kernel<<<blocks, ROWS, 0, (cudaStream_t)stream>>>(
            (const float*)means, (const float*)quats, (const float*)scales,
            aware ? (const float*)opacities : nullptr, (const float*)viewmat,
            (const float*)fx, (const float*)fy, (const float*)cx, (const float*)cy,
            (const float*)centre, (float*)means2d, (float*)conics, (float*)depths,
            (int*)radii, (uint8_t*)valid, (float*)cov2d, (float*)compensation,
            (float*)extents, (float*)dirs, n, P);
    }
    return (int)cudaGetLastError();
}

extern "C" int proj_bwd_launch(
    const void* means, const void* quats, const void* scales, const void* opacities,
    const void* viewmat, const void* fx, const void* fy, const void* cx, const void* cy,
    const void* centre, const void* g_means2d, const void* g_conics, const void* g_depths,
    const void* g_cov2d, const void* g_compensation, const void* g_extents,
    const void* g_dirs, void* grad_means, void* grad_quats, void* grad_scales,
    void* grad_opacities, int n, int width, int height, int aware, float near_plane,
    float dilation, float sigma_cap, float log_skip, void* stream)
{
    if (n > 0) {
        const Settings P{width, height, aware, near_plane, dilation, sigma_cap, log_skip};
        const unsigned blocks = (unsigned)((n + ROWS - 1) / ROWS);
        proj_bwd_kernel<<<blocks, ROWS, 0, (cudaStream_t)stream>>>(
            (const float*)means, (const float*)quats, (const float*)scales,
            aware ? (const float*)opacities : nullptr, (const float*)viewmat,
            (const float*)fx, (const float*)fy, (const float*)cx, (const float*)cy,
            (const float*)centre, (const float*)g_means2d, (const float*)g_conics,
            (const float*)g_depths, (const float*)g_cov2d, (const float*)g_compensation,
            (const float*)g_extents, (const float*)g_dirs, (float*)grad_means,
            (float*)grad_quats, (float*)grad_scales, (float*)grad_opacities, n, P);
    }
    return (int)cudaGetLastError();
}
