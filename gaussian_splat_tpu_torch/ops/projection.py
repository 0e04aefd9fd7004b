"""EWA 3D→2D Gaussian projection: quat→R, Σ=MMᵀ, perspective Jacobian, culling.

Counterpart of gaussian_splat_tpu/ops/projection.py, with the same order of
operations.

Math contract:
  * quaternion (wxyz, normalized) → rotation matrix
  * Σview = (W·R)·S²·(W·R)ᵀ, W = viewmat[:3,:3], expanded elementwise
  * perspective Jacobian J rows (fx/z, 0, −fx·x/z²), (0, fy/z, −fy·y/z²),
    inputs clamped to 1.3× the frustum (3DGS convention)
  * 2×2 pixel covariance = J·Σview·Jᵀ + dilation·I
  * closed-form symmetric 2×2 eigenvalues, radius = √(2·σ_max·λmax)
  * near cull, frustum cull

`project_with_directions` is the render path's stage: the projection and
the unit view directions that SH colour reads, as one differentiable stage
(`_Project`) with an explicit backward that recomputes the forward's
intermediates from its inputs. CUDA float32 tensors go to the two kernels of
csrc/projection.cu, or raise — refused shape, type or contiguity, failed
build or launch: nothing falls back:

  kernel    wrapper              plain version                   replaces (TPU)
  proj_fwd  projection_forward   project_gaussians_torch         none: XLA fused
                                 + view_directions               this stage
  proj_bwd  projection_backward  project_backward_torch          none: XLA fused
                                                                 its VJP

CPU tensors run the same stage through the plain versions, so the CPU tests
exercise the explicit backward formulas. `cuda_raster.launch_counts
["proj_fwd"]` and `["proj_bwd"]` go up by one exactly where a kernel is
launched. `project_gaussians` is the same stage without the directions.
"""

from __future__ import annotations

import types
from typing import NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from gaussian_splat_tpu_torch.camera import Camera
from gaussian_splat_tpu_torch.ops.falloff import log_alpha_skip


class ProjectedGaussians(NamedTuple):
    """Per-gaussian screen-space quantities. All shapes lead with N."""

    means2d: torch.Tensor  # (N, 2) pixel coordinates of the projected center
    conics: torch.Tensor  # (N, 3) upper-triangular inverse 2D covariance (A, B, C);
    #   the falloff is σ(d) = 0.5·(A·dx² + C·dy²) + B·dx·dy
    depths: torch.Tensor  # (N,) camera-space z (positive in front)
    radii: torch.Tensor  # (N,) int32 extent in pixels (0 ⇒ culled)
    valid: torch.Tensor  # (N,) bool — survives near/frustum/degeneracy culling
    cov2d: torch.Tensor  # (N, 3) the (a, b, c) 2D covariance (pre-inverse), for debug
    compensation: Optional[torch.Tensor] = None  # (N,) √(det Σ / det(Σ+dilation·I))
    #   — the "antialiased" opacity factor
    extents: Optional[torch.Tensor] = None  # (N, 2) f32 per-axis billboard
    #   half-widths — the EXACT axis-aligned bounding box of the {σ ≤ σ_max}
    #   ellipse: rx = √(2·σ_max·cov_a), ry = √(2·σ_max·cov_c)


class ProjectionGrads(NamedTuple):
    """Cotangents of the stage's float outputs; None where an output takes
    no gradient (autograd then walks none of its branch)."""

    means2d: Optional[torch.Tensor] = None  # (N, 2)
    conics: Optional[torch.Tensor] = None  # (N, 3)
    depths: Optional[torch.Tensor] = None  # (N,)
    cov2d: Optional[torch.Tensor] = None  # (N, 3)
    compensation: Optional[torch.Tensor] = None  # (N,)
    extents: Optional[torch.Tensor] = None  # (N, 2)
    dirs: Optional[torch.Tensor] = None  # (N, 3)


def _unit_quats(quats: torch.Tensor) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(quats * quats, dim=-1, keepdim=True))
    return quats / torch.clamp_min(norm, 1e-8)


def _rotation_components(q: torch.Tensor):
    """Rotation of unit quaternions as nine (N,) component tensors (row-major)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    )


def _rotmat_rows(quats: torch.Tensor):
    """Unit-quaternion rotation as nine (N,) component tensors (row-major)."""
    return _rotation_components(_unit_quats(quats))


def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """(…,4) wxyz quaternions (not necessarily unit; the norm is clipped at
    1e-8) → (…,3,3) rotations: `_rotmat_rows`, the algebra of the projection
    and of densify, stacked."""
    return torch.stack(_rotmat_rows(quats), dim=-1).unflatten(-1, (3, 3))


def compute_cov3d(quats: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Σ3D = (R·S)(R·S)ᵀ as full (…,3,3), S = diag(scales)."""
    m = quat_to_rotmat(quats) * scales[..., None, :]  # R @ diag(scales)
    return m @ m.transpose(-1, -2)


def _cov_view_components(r, scales, W):
    """Upper-triangular components of Σview = (W·R)·S²·(W·R)ᵀ, elementwise,
    from R's nine components `r`.

    Returns ((s00, s01, s02, s11, s12, s22), U, s2): the six (N,) components,
    U = W·R as nine row-major (N,) components and S² (N, 3). W's entries are
    scalars, so every operation here is (N,)-elementwise: no batched 3×3
    matmul, and no dependence on the matmul precision flags."""
    # U = W @ R, unrolled: U[i][j] = Σ_k W[i,k]·R[k,j]
    U = [
        [
            W[i, 0] * r[0 + j] + W[i, 1] * r[3 + j] + W[i, 2] * r[6 + j]
            for j in range(3)
        ]
        for i in range(3)
    ]
    s2 = scales * scales
    s0, s1, s2_ = s2[:, 0], s2[:, 1], s2[:, 2]

    def sv(i, j):
        return U[i][0] * U[j][0] * s0 + U[i][1] * U[j][1] * s1 + U[i][2] * U[j][2] * s2_

    comps = sv(0, 0), sv(0, 1), sv(0, 2), sv(1, 1), sv(1, 2), sv(2, 2)
    return comps, [u for row in U for u in row], s2


def _opacity_aware(opacities, alpha_skip) -> bool:
    return opacities is not None and alpha_skip is not None and alpha_skip > 0.0


def _terms(means, quats, scales, camera, near_plane, cov2d_dilation, sigma_extent,
           opacities, alpha_skip) -> types.SimpleNamespace:
    """The plain forward, every intermediate kept: the projection's order of
    operations, one torch op at a time (proj_fwd spells the same order)."""
    W = camera.rotation  # (3,3)
    t = camera.translation  # (3,)
    fx, fy, cx, cy = camera.fx, camera.fy, camera.cx, camera.cy
    width, height = camera.width, camera.height

    # --- view transform + near cull ----------------------------------------
    # p_view = means @ Wᵀ + t, written out per component (see
    # _cov_view_components: elementwise, independent of matmul precision)
    mx, my, mz = means[:, 0], means[:, 1], means[:, 2]
    x = mx * W[0, 0] + my * W[0, 1] + mz * W[0, 2] + t[0]
    y = mx * W[1, 0] + my * W[1, 1] + mz * W[1, 2] + t[1]
    z = mx * W[2, 0] + my * W[2, 1] + mz * W[2, 2] + t[2]
    in_front = z > near_plane
    zs = torch.where(in_front, z, 1.0)  # safe denominator for culled splats

    # --- 3D covariance in view space ---------------------------------------
    qnorm = torch.sqrt(torch.sum(quats * quats, dim=-1, keepdim=True))
    qn = quats / torch.clamp_min(qnorm, 1e-8)
    r = _rotation_components(qn)
    (s00, s01, s02, s11, s12, s22), U, s2 = _cov_view_components(r, scales, W)

    # --- perspective Jacobian with frustum-clamped inputs ------------------
    lim_x = 1.3 * (0.5 * width / fx)
    lim_y = 1.3 * (0.5 * height / fy)
    ux, uy = x / zs, y / zs
    vx = torch.maximum(ux, -lim_x)
    vy = torch.maximum(uy, -lim_y)
    wx = torch.minimum(vx, lim_x)
    wy = torch.minimum(vy, lim_y)
    tx = wx * zs
    ty = wy * zs

    inv_z = 1.0 / zs
    inv_z2 = inv_z * inv_z
    # J = [[fx/z, 0, -fx·tx/z²], [0, fy/z, -fy·ty/z²]]  (2,3) per gaussian
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2

    # cov2d = J · Σview · Jᵀ, expanded (avoids materializing (N,2,3) J)
    a0 = j00 * (j00 * s00 + j02 * s02) + j02 * (j00 * s02 + j02 * s22)
    b = j00 * (j11 * s01 + j12 * s02) + j02 * (j11 * s12 + j12 * s22)
    c0 = j11 * (j11 * s11 + j12 * s12) + j12 * (j11 * s12 + j12 * s22)

    det_raw = a0 * c0 - b * b
    a = a0 + cov2d_dilation
    c = c0 + cov2d_dilation

    # --- conic (inverse 2D covariance) -------------------------------------
    det = a * c - b * b
    comp_num = torch.clamp_min(det_raw, 0.0)
    comp_den = torch.clamp_min(det, 1e-12)
    comp_sq = comp_num / comp_den
    compensation = torch.sqrt(comp_sq)
    det_ok = det > 1e-10
    det_safe = torch.where(det_ok, det, 1.0)
    inv_det = 1.0 / det_safe
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    # --- extent: closed-form symmetric 2×2 eigenvalues ---------------------
    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det_safe, 0.1))
    lambda_max = mid + disc
    # σ ≤ σ_max on the contributing set; radius = √(2·σ_max·λmax) bounds its
    # ellipse; the opacity-aware min() only removes provably-zero pixels
    sigma_cap = torch.full_like(z, 0.5 * sigma_extent * sigma_extent)
    sigma_max = sigma_cap
    op_floor = log_op = None
    if _opacity_aware(opacities, alpha_skip):
        op_floor = torch.clamp_min(opacities, 1e-30)
        log_op = torch.log(op_floor) - log_alpha_skip(alpha_skip)
        sigma_max = torch.minimum(sigma_cap, log_op)
    sigma_pos = torch.clamp_min(sigma_max, 0.0)
    radius_f = torch.sqrt(2.0 * sigma_pos * torch.clamp_min(lambda_max, 0.0))
    radii = torch.ceil(radius_f).to(torch.int32)
    # exact ellipse AABB: ±√(2·σ_max·cov_xx) in x and ±√(2·σ_max·cov_yy) in y
    rx = torch.sqrt(2.0 * sigma_pos * torch.clamp_min(a, 0.0))
    ry = torch.sqrt(2.0 * sigma_pos * torch.clamp_min(c, 0.0))

    # --- projected center (pixels) -----------------------------------------
    mean_x = fx * x * inv_z + cx
    mean_y = fy * y * inv_z + cy

    # --- frustum cull: tile rect must intersect the screen -----------------
    on_screen = (
        (mean_x + rx > 0)
        & (mean_x - rx < width)
        & (mean_y + ry > 0)
        & (mean_y - ry < height)
    )
    valid = in_front & det_ok & on_screen & (radii > 0)
    return types.SimpleNamespace(**locals())


def project_gaussians_torch(
    means, quats, scales, camera, *, near_plane=0.01, cov2d_dilation=0.3,
    sigma_extent=3.0, opacities=None, alpha_skip=None,
) -> ProjectedGaussians:
    """The plain forward (proj_fwd's plain version, with `view_directions`):
    `project_gaussians` in torch ops, differentiable by autograd."""
    T = _terms(means, quats, scales, camera, near_plane, cov2d_dilation, sigma_extent,
               opacities, alpha_skip)
    return ProjectedGaussians(
        means2d=torch.stack([T.mean_x, T.mean_y], dim=-1),
        conics=T.conic,
        depths=T.z,
        radii=torch.where(T.valid, T.radii, 0),
        valid=T.valid,
        cov2d=torch.stack([T.a, T.b, T.c], dim=-1),
        compensation=T.compensation,
        extents=torch.stack(
            [torch.where(T.valid, T.rx, 0.0), torch.where(T.valid, T.ry, 0.0)], dim=-1
        ),
    )


def view_directions(means: torch.Tensor, camera: Camera) -> torch.Tensor:
    """Unit directions camera-center → gaussian, for SH evaluation."""
    d = means - camera.position
    norm = torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
    return d / torch.clamp_min(norm, 1e-8)


# -- the explicit backward ------------------------------------------------------


def _min_grad(g, x, other):
    """Gradient to x of torch.minimum(x, other): split evenly at a tie,
    none where x is the larger (autograd's rule; NaN x passes it)."""
    g = torch.where(x == other, g / 2, g)
    return torch.where(x > other, torch.zeros_like(g), g)


def _max_grad(g, x, other):
    """Gradient to x of torch.maximum(x, other), as `_min_grad`."""
    g = torch.where(x == other, g / 2, g)
    return torch.where(x < other, torch.zeros_like(g), g)


def _passes(mask, g):
    """where(mask, g, 0): the gradient of clamp_min (mask x ≥ lo) and of a
    where() select."""
    return torch.where(mask, g, torch.zeros_like(g))


def _unit_backward(g_unit, v, unit, norm):
    """Gradient to v of v / clamp_min(√Σv², 1e-8) (`unit`, `norm` from the
    forward), op by op as autograd takes it; at a zero v, 0 / (2·0) is NaN as
    in autograd."""
    nc = torch.clamp_min(norm, 1e-8)
    g = g_unit / nc
    g_nc = -(g_unit * (unit / nc)).sum(-1, keepdim=True)
    g_ss = _passes(norm >= 1e-8, g_nc) / (2 * norm)
    return g + g_ss * v + g_ss * v


def _sqrt_backward(g, result):
    return g / (2 * result)


def project_backward_torch(
    means, quats, scales, camera, grads: ProjectionGrads, *, near_plane=0.01,
    cov2d_dilation=0.3, sigma_extent=3.0, opacities=None, alpha_skip=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The plain backward (proj_bwd's plain version), by the explicit
    formulas: (grad_means, grad_quats, grad_scales, grad_opacities) of the
    stage's float outputs — `project_gaussians_torch`'s and `view_directions`'
    — under `grads`. The forward's intermediates are recomputed from the
    inputs. An output whose cotangent is None contributes nothing, and a
    branch that no given cotangent reaches is not walked, as in autograd:
    grad_quats and grad_scales are None without a cotangent of the conics,
    cov2d, compensation or extents, grad_opacities without one of the
    extents (or where the extent is not opacity-aware). The rules at the
    kinks are autograd's: clamp_min and where pass the gradient where the
    value was kept (x ≥ lo at equality), minimum/maximum split it evenly at
    a tie, and a square root's gradient is g / (2·result), NaN at 0 / 0."""
    T = _terms(means, quats, scales, camera, near_plane, cov2d_dilation, sigma_extent,
               opacities, alpha_skip)
    fx, fy = T.fx, T.fy
    zero = torch.zeros_like(T.z)
    gx, gy, gz, g_zs, g_inv_z = zero, zero, zero, zero, zero
    g_means = torch.zeros_like(means)

    if grads.dirs is not None:
        d = means - camera.position
        dnorm = torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
        unit = d / torch.clamp_min(dnorm, 1e-8)
        g_means = g_means + _unit_backward(grads.dirs, d, unit, dnorm)
    if grads.depths is not None:
        gz = gz + grads.depths
    if grads.means2d is not None:
        g_mx, g_my = grads.means2d[:, 0], grads.means2d[:, 1]
        gx = gx + g_mx * T.inv_z * fx
        gy = gy + g_my * T.inv_z * fy
        g_inv_z = g_inv_z + g_mx * (fx * T.x) + g_my * (fy * T.y)

    has_cov = any(g is not None for g in (grads.conics, grads.cov2d, grads.compensation,
                                          grads.extents))
    g_quats = g_scales = g_op = None
    if has_cov:
        # gradients of a = a0 + dilation, b, c = c0 + dilation, det
        g_a, g_b, g_c, g_det = zero, zero, zero, zero
        g_a0, g_c0 = zero, zero
        if grads.cov2d is not None:
            g_a, g_b, g_c = g_a + grads.cov2d[:, 0], g_b + grads.cov2d[:, 1], g_c + grads.cov2d[:, 2]
        if grads.conics is not None:
            k0, k1, k2 = grads.conics[:, 0], grads.conics[:, 1], grads.conics[:, 2]
            g_c = g_c + k0 * T.inv_det
            g_b = g_b - k1 * T.inv_det
            g_a = g_a + k2 * T.inv_det
            g_inv_det = k0 * T.c + k1 * (-T.b) + k2 * T.a
            g_det_safe = -g_inv_det * (T.inv_det * T.inv_det)
            g_det = g_det + _passes(T.det_ok, g_det_safe)
        if grads.compensation is not None:
            g_sq = _sqrt_backward(grads.compensation, T.compensation)
            g_num = g_sq / T.comp_den
            g_den = -g_sq * (T.comp_sq / T.comp_den)
            g_det_raw = _passes(T.det_raw >= 0.0, g_num)
            g_det = g_det + _passes(T.det >= 1e-12, g_den)
            g_a0 = g_a0 + g_det_raw * T.c0
            g_c0 = g_c0 + g_det_raw * T.a0
            g_b = g_b - 2 * (g_det_raw * T.b)
        if grads.extents is not None:
            two_sp = 2.0 * T.sigma_pos

            def extent_backward(g_e, r, cov):
                """rx = √(2σ⁺·max(a, 0)) (ry with c): (to 2σ⁺, to a)"""
                g_p = _sqrt_backward(_passes(T.valid, g_e), r)
                return g_p * torch.clamp_min(cov, 0.0), _passes(cov >= 0.0, g_p * two_sp)

            g_two_sp_x, g_ax = extent_backward(grads.extents[:, 0], T.rx, T.a)
            g_two_sp_y, g_cy = extent_backward(grads.extents[:, 1], T.ry, T.c)
            g_a, g_c = g_a + g_ax, g_c + g_cy
            g_sigma_max = _passes(T.sigma_max >= 0.0, 2.0 * (g_two_sp_x + g_two_sp_y))
            if T.log_op is not None:
                g_log = _min_grad(g_sigma_max, T.log_op, T.sigma_cap)
                g_op = _passes(opacities >= 1e-30, g_log / T.op_floor)
        g_a = g_a + g_det * T.c
        g_c = g_c + g_det * T.a
        g_b = g_b - 2 * (g_det * T.b)
        g_a0, g_c0 = g_a0 + g_a, g_c0 + g_c

        # a0, b, c0 = J·Σview·Jᵀ
        j00, j02, j11, j12 = T.j00, T.j02, T.j11, T.j12
        s00, s01, s02, s11, s12, s22 = T.s00, T.s01, T.s02, T.s11, T.s12, T.s22
        g_j00 = 2 * g_a0 * (j00 * s00 + j02 * s02) + g_b * (j11 * s01 + j12 * s02)
        g_j02 = 2 * g_a0 * (j00 * s02 + j02 * s22) + g_b * (j11 * s12 + j12 * s22)
        g_j11 = g_b * (j00 * s01 + j02 * s12) + 2 * g_c0 * (j11 * s11 + j12 * s12)
        g_j12 = g_b * (j00 * s02 + j02 * s22) + 2 * g_c0 * (j11 * s12 + j12 * s22)
        g_s = (
            g_a0 * j00 * j00,  # s00
            g_b * j00 * j11,  # s01
            2 * g_a0 * j00 * j02 + g_b * j00 * j12,  # s02
            g_c0 * j11 * j11,  # s11
            g_b * j02 * j11 + 2 * g_c0 * j11 * j12,  # s12
            g_a0 * j02 * j02 + g_b * j02 * j12 + g_c0 * j12 * j12,  # s22
        )

        # J from (tx, ty) and 1/z
        g_inv_z = g_inv_z + g_j00 * fx + g_j11 * fy
        g_inv_z2 = g_j02 * (-fx * T.tx) + g_j12 * (-fy * T.ty)
        g_inv_z = g_inv_z + 2 * g_inv_z2 * T.inv_z

        def clamp_backward(g_j, f, u, v, w, lim):
            """t = min(max(u, −lim), lim)·zs, u = coordinate / zs, under the
            gradient of j = −f·t/z²: (to the coordinate, to zs)"""
            g_t = g_j * T.inv_z2 * (-f)
            g_u = _max_grad(_min_grad(g_t * T.zs, v, lim), u, -lim)
            return g_u / T.zs, g_t * w - g_u * (u / T.zs)

        g_x, g_zs_x = clamp_backward(g_j02, fx, T.ux, T.vx, T.wx, T.lim_x)
        g_y, g_zs_y = clamp_backward(g_j12, fy, T.uy, T.vy, T.wy, T.lim_y)
        gx, gy, g_zs = gx + g_x, gy + g_y, g_zs + g_zs_x + g_zs_y

        # Σview = U·S²·Uᵀ (upper triangle), U = W·R
        U = T.U
        G = ((2 * g_s[0], g_s[1], g_s[2]), (g_s[1], 2 * g_s[3], g_s[4]),
             (g_s[2], g_s[4], 2 * g_s[5]))  # G + Gᵀ of the upper triangle
        s2 = (T.s2[:, 0], T.s2[:, 1], T.s2[:, 2])
        g_U = [sum(G[i][m] * U[3 * m + k] for m in range(3)) * s2[k]
               for i in range(3) for k in range(3)]
        g_s2 = torch.stack([
            sum(g_s[idx] * U[3 * i + k] * U[3 * j + k]
                for idx, (i, j) in enumerate(((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))))
            for k in range(3)
        ], dim=-1)
        g_scales = 2 * g_s2 * scales
        W = camera.rotation
        g_r = [sum(W[i, k] * g_U[3 * i + j] for i in range(3)) for k in range(3) for j in range(3)]
        w, x, y, z = T.qn[:, 0], T.qn[:, 1], T.qn[:, 2], T.qn[:, 3]
        g0, g1, g2, g3, g4, g5, g6, g7, g8 = g_r
        g_qn = 2 * torch.stack([
            -z * g1 + y * g2 + z * g3 - x * g5 - y * g6 + x * g7,
            y * g1 + z * g2 + y * g3 - 2 * x * g4 - w * g5 + z * g6 + w * g7 - 2 * x * g8,
            -2 * y * g0 + x * g1 + w * g2 + x * g3 + z * g5 - w * g6 + z * g7 - 2 * y * g8,
            -2 * z * g0 - w * g1 + x * g2 + w * g3 - 2 * z * g4 + y * g5 + x * g6 + y * g7,
        ], dim=-1)
        g_quats = _unit_backward(g_qn, quats, T.qn, T.qnorm)

    # zs = where(in_front, z, 1), 1/zs; p_view = means·Wᵀ + t
    gz = gz + _passes(T.in_front, g_zs - g_inv_z * (T.inv_z * T.inv_z))
    W = camera.rotation
    g_view = torch.stack([
        gx * W[0, k] + gy * W[1, k] + gz * W[2, k] for k in range(3)
    ], dim=-1)
    return g_means + g_view, g_quats, g_scales, g_op


# -- the kernels' wrappers and the differentiable stage -------------------------


class _Settings(NamedTuple):
    """The stage's scalar settings, as the kernels take them."""

    near_plane: float
    cov2d_dilation: float
    sigma_extent: float
    alpha_skip: Optional[float]

    def plain_kwargs(self, opacities) -> dict:
        return dict(near_plane=self.near_plane, cov2d_dilation=self.cov2d_dilation,
                    sigma_extent=self.sigma_extent, opacities=opacities,
                    alpha_skip=self.alpha_skip)

    def launch_args(self, camera: Camera, aware: bool):
        """The kernels' trailing int and float arguments: width, height, the
        opacity-aware flag; near plane, dilation, the σ cap and ln(α_skip),
        each rounded to float32 as torch rounds a Python scalar."""
        cap = 0.5 * self.sigma_extent * self.sigma_extent
        log_skip = log_alpha_skip(self.alpha_skip) if aware else 0.0
        return (camera.width, camera.height, int(aware),
                self.near_plane, self.cov2d_dilation, cap, log_skip)


def _check_inputs(means, quats, scales, opacities, camera, aware) -> int:
    """N of the kernels' inputs, or raises on what they do not take."""
    from gaussian_splat_tpu_torch.ops import cuda_raster

    n = means.shape[0] if means.dim() == 2 else -1
    cuda_raster._check("means", means, torch.float32, (n, 3), align=4)
    cuda_raster._check("quats", quats, torch.float32, (n, 4), means, align=4)
    cuda_raster._check("scales", scales, torch.float32, (n, 3), means, align=4)
    if aware:
        cuda_raster._check("opacities", opacities, torch.float32, (n,), means, align=4)
    cuda_raster._check("viewmat", camera.viewmat, torch.float32, (4, 4), means, align=4)
    for name in ("fx", "fy", "cx", "cy"):
        cuda_raster._check(name, getattr(camera, name), torch.float32, (), means, align=4)
    return n


def _camera_pointers(camera: Camera, position: torch.Tensor):
    return (camera.viewmat.data_ptr(), camera.fx.data_ptr(), camera.fy.data_ptr(),
            camera.cx.data_ptr(), camera.cy.data_ptr(), position.data_ptr())


def projection_forward(means, quats, scales, opacities, camera: Camera, settings: _Settings):
    """The forward kernel: (ProjectedGaussians, dirs (N, 3)), no autograd
    graph (`project_with_directions` is the differentiable stage). CUDA
    tensors go to the kernel (or raise); CPU tensors to the plain versions."""
    if not means.is_cuda:
        with torch.no_grad():
            return (project_gaussians_torch(means, quats, scales, camera,
                                            **settings.plain_kwargs(opacities)),
                    view_directions(means, camera))
    from gaussian_splat_tpu_torch.ops import cuda_raster

    aware = _opacity_aware(opacities, settings.alpha_skip)
    n = _check_inputs(means, quats, scales, opacities, camera, aware)
    launch = cuda_raster._launcher("proj_fwd", "projection")
    dev = means.device
    with cuda_raster._on(dev), torch.no_grad():
        position = camera.position  # the plain version's camera centre, bit for bit
        f32 = dict(dtype=torch.float32, device=dev)
        out = ProjectedGaussians(
            means2d=torch.empty((n, 2), **f32), conics=torch.empty((n, 3), **f32),
            depths=torch.empty((n,), **f32),
            radii=torch.empty((n,), dtype=torch.int32, device=dev),
            valid=torch.empty((n,), dtype=torch.bool, device=dev),
            cov2d=torch.empty((n, 3), **f32), compensation=torch.empty((n,), **f32),
            extents=torch.empty((n, 2), **f32),
        )
        dirs = torch.empty((n, 3), **f32)
        err = launch(
            means.data_ptr(), quats.data_ptr(), scales.data_ptr(),
            opacities.data_ptr() if aware else None,
            *_camera_pointers(camera, position),
            *(t.data_ptr() for t in out), dirs.data_ptr(),
            n, *settings.launch_args(camera, aware), cuda_raster._stream(dev),
        )
    if err != 0:
        raise RuntimeError(f"proj_fwd launch failed: CUDA error {err}")
    cuda_raster.launch_counts["proj_fwd"] += 1
    return out, dirs


def projection_backward(means, quats, scales, opacities, camera: Camera,
                        settings: _Settings, grads: ProjectionGrads):
    """The backward kernel: (grad_means, grad_quats, grad_scales,
    grad_opacities), each None where `project_backward_torch` gives None.
    CUDA tensors go to the kernel (or raise); CPU tensors to the plain
    version."""
    if not means.is_cuda:
        return project_backward_torch(means, quats, scales, camera, grads,
                                      **settings.plain_kwargs(opacities))
    from gaussian_splat_tpu_torch.ops import cuda_raster

    aware = _opacity_aware(opacities, settings.alpha_skip)
    n = _check_inputs(means, quats, scales, opacities, camera, aware)
    widths = dict(means2d=(n, 2), conics=(n, 3), depths=(n,), cov2d=(n, 3),
                  compensation=(n,), extents=(n, 2), dirs=(n, 3))
    for name, g in grads._asdict().items():
        if g is not None:
            cuda_raster._check(f"grad_{name}", g, torch.float32, widths[name], means, align=4)
    has_cov = any(g is not None for g in (grads.conics, grads.cov2d, grads.compensation,
                                          grads.extents))
    has_op = aware and grads.extents is not None
    launch = cuda_raster._launcher("proj_bwd", "projection")
    dev = means.device
    with cuda_raster._on(dev), torch.no_grad():
        position = camera.position
        g_means = torch.empty_like(means)
        g_quats = torch.empty_like(quats) if has_cov else None
        g_scales = torch.empty_like(scales) if has_cov else None
        g_op = torch.empty_like(opacities) if has_op else None
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        err = launch(
            means.data_ptr(), quats.data_ptr(), scales.data_ptr(),
            ptr(opacities) if aware else None,
            *_camera_pointers(camera, position),
            *(ptr(g) for g in grads),
            g_means.data_ptr(), ptr(g_quats), ptr(g_scales), ptr(g_op),
            n, *settings.launch_args(camera, aware), cuda_raster._stream(dev),
        )
    if err != 0:
        raise RuntimeError(f"proj_bwd launch failed: CUDA error {err}")
    cuda_raster.launch_counts["proj_bwd"] += 1
    return g_means, g_quats, g_scales, g_op


class _Project(torch.autograd.Function):
    """Projection and view directions as one differentiable stage; see the
    module docstring. Saves only its inputs; an output that can take no
    gradient from the inputs that require one is marked non-differentiable,
    so that autograd walks no branch that its own graph would not have."""

    @staticmethod
    def forward(ctx, means, quats, scales, opacities, camera, settings):
        ctx.set_materialize_grads(False)
        ctx.camera, ctx.settings = camera, settings
        ctx.save_for_backward(means, quats, scales, opacities)
        proj, dirs = projection_forward(means, quats, scales, opacities, camera, settings)
        geometry = any(ctx.needs_input_grad[:3])
        aware = _opacity_aware(opacities, settings.alpha_skip)
        fixed = [proj.radii, proj.valid]
        if not geometry:
            fixed += [proj.means2d, proj.conics, proj.depths, proj.cov2d, proj.compensation]
        if not (geometry or (aware and ctx.needs_input_grad[3])):
            fixed.append(proj.extents)
        if not ctx.needs_input_grad[0]:
            fixed.append(dirs)
        ctx.mark_non_differentiable(*fixed)
        return (*proj, dirs)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_means2d, g_conics, g_depths, _g_radii, _g_valid, g_cov2d,
                 g_compensation, g_extents, g_dirs):
        means, quats, scales, opacities = ctx.saved_tensors
        grads = ProjectionGrads(*(None if g is None else g.contiguous() for g in (
            g_means2d, g_conics, g_depths, g_cov2d, g_compensation, g_extents, g_dirs)))
        g_means, g_quats, g_scales, g_op = projection_backward(
            means, quats, scales, opacities, ctx.camera, ctx.settings, grads)
        return g_means, g_quats, g_scales, g_op, None, None


def project_with_directions(
    means: torch.Tensor,  # (N, 3) world positions
    quats: torch.Tensor,  # (N, 4) wxyz
    scales: torch.Tensor,  # (N, 3) activated (positive) scales
    camera: Camera,
    *,
    near_plane: float = 0.01,
    cov2d_dilation: float = 0.3,
    sigma_extent: float = 3.0,
    opacities: Optional[torch.Tensor] = None,  # (N,) activated opacities
    alpha_skip: Optional[float] = None,
) -> Tuple[ProjectedGaussians, torch.Tensor]:
    """`project_gaussians` and the unit view directions (N, 3) camera centre
    → gaussian that SH colour reads, as one stage: proj_fwd on CUDA tensors
    (float32, contiguous; anything else raises), the plain versions on CPU
    tensors; the gradient is proj_bwd's or its plain version's. The camera
    takes no gradient: a camera tensor that requires one raises."""
    if torch.is_grad_enabled() and any(
        getattr(camera, k).requires_grad for k in ("viewmat", "fx", "fy", "cx", "cy")
    ):
        raise ValueError("the projection takes no gradient of the camera")
    settings = _Settings(near_plane, cov2d_dilation, sigma_extent, alpha_skip)
    *fields, dirs = _Project.apply(means, quats, scales, opacities, camera, settings)
    return ProjectedGaussians(*fields), dirs


def project_gaussians(
    means: torch.Tensor,  # (N, 3) world positions
    quats: torch.Tensor,  # (N, 4) wxyz
    scales: torch.Tensor,  # (N, 3) activated (positive) scales
    camera: Camera,
    *,
    near_plane: float = 0.01,
    cov2d_dilation: float = 0.3,
    sigma_extent: float = 3.0,
    opacities: Optional[torch.Tensor] = None,  # (N,) activated opacities
    alpha_skip: Optional[float] = None,
) -> ProjectedGaussians:
    """Project all gaussians to screen space and cull.

    Differentiable w.r.t. means/quats/scales. When `opacities` and
    `alpha_skip` are given, the billboard extent is opacity-aware: a splat's
    contribution α = op·exp(−σ) falls below `alpha_skip` — and is zeroed by
    EVERY backend's keep test — once σ > ln(op/alpha_skip), so the radius
    shrinks to √(2·min(σ_cutoff, ln(op/alpha_skip))·λmax) with NO change in
    rendered output; splats with op ≤ alpha_skip cull outright. The stage of
    `project_with_directions`, its directions left out."""
    return project_with_directions(
        means, quats, scales, camera, near_plane=near_plane, cov2d_dilation=cov2d_dilation,
        sigma_extent=sigma_extent, opacities=opacities, alpha_skip=alpha_skip,
    )[0]
