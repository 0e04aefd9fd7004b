"""EWA 3D→2D Gaussian projection: quat→R, Σ=MMᵀ, perspective Jacobian, culling.

Counterpart of gaussian_splat_tpu/ops/projection.py, with the same order of
operations. Plain torch ops over all N splats at once, differentiable
end-to-end by autograd (the JAX package leaves this stage to XLA too).

Math contract:
  * quaternion (wxyz, normalized) → rotation matrix
  * Σview = (W·R)·S²·(W·R)ᵀ, W = viewmat[:3,:3], expanded elementwise
  * perspective Jacobian J rows (fx/z, 0, −fx·x/z²), (0, fy/z, −fy·y/z²),
    inputs clamped to 1.3× the frustum (3DGS convention)
  * 2×2 pixel covariance = J·Σview·Jᵀ + dilation·I
  * closed-form symmetric 2×2 eigenvalues, radius = √(2·σ_max·λmax)
  * near cull, frustum cull
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

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


def _unit_quats(quats: torch.Tensor) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(quats * quats, dim=-1, keepdim=True))
    return quats / torch.clamp_min(norm, 1e-8)


def _rotmat_rows(quats: torch.Tensor):
    """Unit-quaternion rotation as nine (N,) component tensors (row-major)."""
    q = _unit_quats(quats)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    )


def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """(…,4) wxyz quaternions (not necessarily unit; the norm is clipped at
    1e-8) → (…,3,3) rotations: `_rotmat_rows`, the algebra of the projection
    and of densify, stacked."""
    return torch.stack(_rotmat_rows(quats), dim=-1).unflatten(-1, (3, 3))


def compute_cov3d(quats: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Σ3D = (R·S)(R·S)ᵀ as full (…,3,3), S = diag(scales)."""
    m = quat_to_rotmat(quats) * scales[..., None, :]  # R @ diag(scales)
    return m @ m.transpose(-1, -2)


def _cov_view_components(quats, scales, W):
    """Upper-triangular components of Σview = (W·R)·S²·(W·R)ᵀ, elementwise.

    Returns (s00, s01, s02, s11, s12, s22) as (N,) tensors. W's entries are
    scalars, so every operation here is (N,)-elementwise: no batched 3×3
    matmul, and no dependence on the matmul precision flags."""
    r = _rotmat_rows(quats)  # row-major 3×3 components
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

    return sv(0, 0), sv(0, 1), sv(0, 2), sv(1, 1), sv(1, 2), sv(2, 2)


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
    rendered output; splats with op ≤ alpha_skip cull outright."""
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
    s00, s01, s02, s11, s12, s22 = _cov_view_components(quats, scales, W)

    # --- perspective Jacobian with frustum-clamped inputs ------------------
    lim_x = 1.3 * (0.5 * width / fx)
    lim_y = 1.3 * (0.5 * height / fy)
    tx = torch.minimum(torch.maximum(x / zs, -lim_x), lim_x) * zs
    ty = torch.minimum(torch.maximum(y / zs, -lim_y), lim_y) * zs

    inv_z = 1.0 / zs
    inv_z2 = inv_z * inv_z
    # J = [[fx/z, 0, -fx·tx/z²], [0, fy/z, -fy·ty/z²]]  (2,3) per gaussian
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2

    # cov2d = J · Σview · Jᵀ, expanded (avoids materializing (N,2,3) J)
    a = j00 * (j00 * s00 + j02 * s02) + j02 * (j00 * s02 + j02 * s22)
    b = j00 * (j11 * s01 + j12 * s02) + j02 * (j11 * s12 + j12 * s22)
    c = j11 * (j11 * s11 + j12 * s12) + j12 * (j11 * s12 + j12 * s22)

    det_raw = a * c - b * b
    a = a + cov2d_dilation
    c = c + cov2d_dilation

    # --- conic (inverse 2D covariance) -------------------------------------
    det = a * c - b * b
    compensation = torch.sqrt(
        torch.clamp_min(det_raw, 0.0) / torch.clamp_min(det, 1e-12)
    )
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
    sigma_max = torch.full_like(z, 0.5 * sigma_extent * sigma_extent)
    if opacities is not None and alpha_skip is not None and alpha_skip > 0.0:
        sigma_max = torch.minimum(
            sigma_max,
            torch.log(torch.clamp_min(opacities, 1e-30)) - log_alpha_skip(alpha_skip),
        )
    sigma_pos = torch.clamp_min(sigma_max, 0.0)
    radius_f = torch.sqrt(2.0 * sigma_pos * torch.clamp_min(lambda_max, 0.0))
    radii = torch.ceil(radius_f).to(torch.int32)
    # exact ellipse AABB: ±√(2·σ_max·cov_xx) in x and ±√(2·σ_max·cov_yy) in y
    rx = torch.sqrt(2.0 * sigma_pos * torch.clamp_min(a, 0.0))
    ry = torch.sqrt(2.0 * sigma_pos * torch.clamp_min(c, 0.0))

    # --- projected center (pixels) -----------------------------------------
    mean_x = fx * x * inv_z + cx
    mean_y = fy * y * inv_z + cy
    means2d = torch.stack([mean_x, mean_y], dim=-1)

    # --- frustum cull: tile rect must intersect the screen -----------------
    on_screen = (
        (mean_x + rx > 0)
        & (mean_x - rx < width)
        & (mean_y + ry > 0)
        & (mean_y - ry < height)
    )
    valid = in_front & det_ok & on_screen & (radii > 0)
    radii = torch.where(valid, radii, 0)
    extents = torch.stack(
        [torch.where(valid, rx, 0.0), torch.where(valid, ry, 0.0)], dim=-1
    )

    return ProjectedGaussians(
        means2d=means2d,
        conics=conic,
        depths=z,
        radii=radii,
        valid=valid,
        cov2d=torch.stack([a, b, c], dim=-1),
        compensation=compensation,
        extents=extents,
    )


def view_directions(means: torch.Tensor, camera: Camera) -> torch.Tensor:
    """Unit directions camera-center → gaussian, for SH evaluation."""
    d = means - camera.position
    norm = torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
    return d / torch.clamp_min(norm, 1e-8)
