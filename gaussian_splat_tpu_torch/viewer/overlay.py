"""Line-geometry overlay: grid/axes renderables composited with splat renders.

Counterpart of gaussian_splat_tpu/viewer/overlay.py, in plain torch on the
viewer's device (the JAX package leaves the overlay to XLA, not to a Pallas
kernel):
  * `Renderable`, `grid`, `axes`, `triangle_mesh`, `point_cloud`: the scene
    objects (an N×N line lattice, RGB axis segments, a mesh's edges, points).
  * `render_overlay`: project world-space vertices with the shared camera and
    rasterize anti-aliased lines/points into an (rgb, coverage) layer.
  * `composite_over_background`: the reference's pass order — geometry first,
    splats over it: the overlay acts as the background that the splats'
    residual transmittance reveals.

Memory: the JAX function builds (S, H, W) temporaries for an object of S
segments, which XLA fuses. Eagerly at 1920×1080 each would take S × 8 MB, so
`render_overlay` walks the segments in chunks of `_CHUNK` and carries three
per-pixel sums instead. Order of accumulation, per object: chunk by chunk in
segment order, a chunk's terms reduced over its segments first, then

    T    ← T · Π_chunk (1 − α)        (the object's transmittance)
    Σα   ← Σα + Σ_chunk α
    Σαc  ← Σαc + Σ_chunk α·c          (per channel)

and at the object's end, as in JAX: coverage = 1 − T, colour = Σαc / max(Σα,
1e-6), blended over the layers of the objects before it.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from gaussian_splat_tpu_torch.camera import Camera

_CHUNK = 8  # segments (or points) per (chunk, H, W) temporary


@dataclasses.dataclass
class Renderable:
    """vertices (V,3) float32, colors (V,3) float32 in [0,1], and a primitive
    kind: 'lines' (independent segments, V even) or 'points'."""

    vertices: np.ndarray
    colors: np.ndarray
    kind: str = "lines"
    model_matrix: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32)
    )


def grid(size: int = 10, spacing: float = 1.0, color=(0.35, 0.35, 0.4)) -> Renderable:
    """N×N line lattice on the y=0 plane."""
    half = size * spacing / 2.0
    verts = []
    for i in range(size + 1):
        p = -half + i * spacing
        verts += [[p, 0.0, -half], [p, 0.0, half]]
        verts += [[-half, 0.0, p], [half, 0.0, p]]
    v = np.asarray(verts, np.float32)
    c = np.broadcast_to(np.asarray(color, np.float32), v.shape).copy()
    return Renderable(v, c, "lines")


def axes(length: float = 2.0) -> Renderable:
    """RGB world-axis segments."""
    v = np.asarray(
        [
            [0, 0, 0], [length, 0, 0],
            [0, 0, 0], [0, length, 0],
            [0, 0, 0], [0, 0, length],
        ],
        np.float32,
    )
    c = np.asarray(
        [
            [1, 0.2, 0.2], [1, 0.2, 0.2],
            [0.2, 1, 0.2], [0.2, 1, 0.2],
            [0.3, 0.5, 1], [0.3, 0.5, 1],
        ],
        np.float32,
    )
    return Renderable(v, c, "lines")


def triangle_mesh(vertices, colors) -> Renderable:
    """Wireframe triangle mesh: (F,3,3) triangles → edge segments."""
    tris = np.asarray(vertices, np.float32).reshape(-1, 3, 3)
    cols = np.broadcast_to(np.asarray(colors, np.float32), tris.shape).reshape(-1, 3, 3)
    edges = []
    ecols = []
    for a, b in [(0, 1), (1, 2), (2, 0)]:
        edges.append(np.stack([tris[:, a], tris[:, b]], axis=1))
        ecols.append(np.stack([cols[:, a], cols[:, b]], axis=1))
    v = np.concatenate(edges).reshape(-1, 3)
    c = np.concatenate(ecols).reshape(-1, 3)
    return Renderable(v, c, "lines")


def point_cloud(points, colors) -> Renderable:
    """Colored points."""
    return Renderable(
        np.asarray(points, np.float32), np.asarray(colors, np.float32), "points"
    )


def _project_points(verts: torch.Tensor, camera: Camera):
    """World → pixel coords + camera depth (the splat pipeline's convention)."""
    R = camera.rotation
    t = camera.translation
    p = verts @ R.T + t
    z = p[:, 2]
    zs = torch.where(z > 1e-6, z, 1e-6)
    px = camera.fx * p[:, 0] / zs + camera.cx
    py = camera.fy * p[:, 1] / zs + camera.cy
    return torch.stack([px, py], -1), z


def _segment_alpha(xs, ys, a, b, vis, line_width):
    """(C, H, W) coverage of C anti-aliased segments a→b (pixel coords)."""
    ab = b - a  # (C,2)
    len2 = torch.clamp_min(torch.sum(ab * ab, -1), 1e-12)
    abx, aby = ab[:, 0, None, None], ab[:, 1, None, None]
    pax = xs[None] - a[:, 0, None, None]
    pay = ys[None] - a[:, 1, None, None]
    tpar = torch.clamp((pax * abx + pay * aby) / len2[:, None, None], 0.0, 1.0)
    dx = pax - tpar * abx
    dy = pay - tpar * aby
    d = torch.sqrt(dx * dx + dy * dy)
    return torch.clamp(line_width + 0.5 - d, 0.0, 1.0) * vis[:, None, None]


def _point_alpha(xs, ys, p, vis, point_radius):
    """(C, H, W) coverage of C anti-aliased discs centred at p."""
    dx = xs[None] - p[:, 0, None, None]
    dy = ys[None] - p[:, 1, None, None]
    d = torch.sqrt(dx * dx + dy * dy)
    return torch.clamp(point_radius + 0.5 - d, 0.0, 1.0) * vis[:, None, None]


@torch.no_grad()
def render_overlay(
    objects: Sequence[Renderable],
    camera: Camera,
    line_width: float = 1.2,
    point_radius: float = 2.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rasterize renderables → (rgb (H,W,3), coverage (H,W)) layers on the
    camera's device."""
    dev = camera.device
    H, W = camera.height, camera.width
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(W, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij",
    )
    rgb = torch.zeros((H, W, 3), device=dev)
    cov = torch.zeros((H, W), device=dev)

    for obj in objects:
        model = torch.as_tensor(obj.model_matrix, dtype=torch.float32, device=dev)
        verts = torch.as_tensor(obj.vertices, dtype=torch.float32, device=dev)
        verts = verts @ model[:3, :3].T + model[:3, 3]
        pix, z = _project_points(verts, camera)
        cols = torch.as_tensor(obj.colors, dtype=torch.float32, device=dev)
        if obj.kind == "lines":
            a, b, ca = pix[0::2], pix[1::2], cols[0::2]
            vis = ((z[0::2] > 1e-6) & (z[1::2] > 1e-6)).to(torch.float32)
        else:  # points
            a, b, ca = pix, None, cols
            vis = (z > 1e-6).to(torch.float32)

        trans = torch.ones((H, W), device=dev)
        a_sum = torch.zeros((H, W), device=dev)
        ac_sum = torch.zeros((H, W, 3), device=dev)
        for s0 in range(0, a.shape[0], _CHUNK):
            s1 = s0 + _CHUNK
            if b is None:
                alpha = _point_alpha(xs, ys, a[s0:s1], vis[s0:s1], point_radius)
            else:
                alpha = _segment_alpha(xs, ys, a[s0:s1], b[s0:s1], vis[s0:s1], line_width)
            trans = trans * torch.prod(1.0 - alpha, dim=0)
            a_sum = a_sum + alpha.sum(dim=0)
            ac_sum = ac_sum + torch.einsum("shw,sc->hwc", alpha, ca[s0:s1])
        layer_cov = 1.0 - trans
        layer_rgb = ac_sum / torch.clamp_min(a_sum[..., None], 1e-6)

        rgb = rgb * (1 - layer_cov[..., None]) + layer_rgb * layer_cov[..., None]
        cov = 1.0 - (1.0 - cov) * (1.0 - layer_cov)

    return rgb, cov


def composite_over_background(
    splat_image: torch.Tensor,
    t_final: torch.Tensor,
    overlay_rgb: torch.Tensor,
    overlay_cov: torch.Tensor,
    background=(0.1, 0.1, 0.15),
) -> torch.Tensor:
    """Splats over overlay over clear color — the reference's pass order
    (clear color first, then geometry, then splats blended over). Assumes
    splat_image was rendered with a BLACK background so T_final carries the
    residual."""
    bg = torch.as_tensor(background, dtype=torch.float32, device=splat_image.device)
    under = overlay_rgb * overlay_cov[..., None] + bg * (1.0 - overlay_cov[..., None])
    return splat_image + t_final[..., None] * under
