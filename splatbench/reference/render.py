"""Plain PyTorch reference of a splat frame: projection, SH of degree 0-3,
and front-to-back compositing, written from the semantics alone.

It imports nothing of the program and takes nothing the program made: the
splats' five raw leaves and the camera's numbers come from the benchmark
(splatbench/scene.py), the semantic constants from the configuration file.

Semantics (those of 3D Gaussian Splatting with an opacity-aware cull):

  * Σ = R·S²·Rᵀ from the unit quaternion and exp(log_scales); the EWA
    Jacobian at the camera-space mean, its x/z and y/z clamped to 1.3× the
    half field of view; 2D covariance J·W·Σ·Wᵀ·Jᵀ + dilation·I.
  * A splat is drawn where camera z > near plane, det > 1e-10, op >
    alpha_skip and its ellipse {σ ≤ bound} meets the screen, with
    σ = ½·A·dx² + B·dx·dy + ½·C·dy² (A, B, C the conic, dx, dy from the
    projected mean to the pixel centre) and bound = min(½·extent²,
    ln op − ln alpha_skip).
  * At a pixel a splat has α = min(op·e^(−σ), alpha_clamp) where 0 ≤ σ ≤
    bound, else 0. Splats composite front to back in the order of their
    camera z rounded to float32 as ((x·w20 + y·w21) + z·w22) + t2 (ties to
    the lower index): colour = Σ T·α·c + T_final·background, T the product
    of (1 − α) in front.
  * Colour c = max(SH(dir) + 0.5, 0), dir the unit vector from the camera
    centre to the mean.

How it is computed: every (splat, pixel) fragment inside each splat's
ellipse bounding box is made, in bands of whole tile rows so that a band
fits; fragments are sorted by (pixel, depth rank); T comes from a
segmented sum of log(1 − α) in float64. With `dtype=torch.float64` this is
the reference; with `dtype=torch.bfloat16` every per-splat and per-fragment
quantity is rounded to bfloat16 (the clamp of α, the sums and, in training,
the image and the loss stay in float32 or more): the control.

`counts=True` also returns what a tile rasteriser needs for these inputs
(splatbench/costs.py takes them): the (splat, tile) pairs with a kept pixel,
and the (pixel, pair) steps before each tile saturates (every pixel's T
below `transmittance_eps`).
"""

from __future__ import annotations

import math
import struct
from typing import Dict, NamedTuple

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
ACC = torch.float64  # sums, prefix sums, transmittance
FRAGMENTS_PER_BAND = 1 << 25
TILE_W, TILE_H = 32, 16
TRANSMITTANCE_EPS = 1e-6


def f32(x: float) -> float:
    """x rounded to float32."""
    return struct.unpack("f", struct.pack("f", x))[0]


class Splats2D(NamedTuple):
    """Per-splat screen quantities, all (N,) in the working dtype."""

    mx: torch.Tensor
    my: torch.Tensor
    a: torch.Tensor  # conic A, B, C
    b: torch.Tensor
    c: torch.Tensor
    op: torch.Tensor
    bound: torch.Tensor
    r: torch.Tensor  # colour
    g: torch.Tensor
    bl: torch.Tensor

    def stacked(self) -> torch.Tensor:
        return torch.stack(self, dim=-1)


class Layout(NamedTuple):
    """The non-differentiable decisions: who is drawn, in which order, where."""

    valid: torch.Tensor  # (N,) bool
    rank: torch.Tensor  # (N,) int64 depth rank (invalid: past the valid ones)
    x0: torch.Tensor  # (N,) int64 first and last pixel column / row
    x1: torch.Tensor
    y0: torch.Tensor
    y1: torch.Tensor


def _rotation(q):
    q = q / torch.sqrt((q * q).sum(-1, keepdim=True)).clamp_min(1e-8)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def _sh_colour(sh, dirs, degree):
    x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    out = SH_C0 * sh[:, 0]
    if degree >= 1:
        out = out - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] - SH_C1 * x * sh[:, 3]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        out = (out + SH_C2[0] * x * y * sh[:, 4] + SH_C2[1] * y * z * sh[:, 5]
               + SH_C2[2] * (2 * zz - xx - yy) * sh[:, 6] + SH_C2[3] * x * z * sh[:, 7]
               + SH_C2[4] * (xx - yy) * sh[:, 8])
    if degree >= 3:
        out = (out + SH_C3[0] * y * (3 * xx - yy) * sh[:, 9] + SH_C3[1] * x * y * z * sh[:, 10]
               + SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
               + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
               + SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
               + SH_C3[5] * z * (xx - yy) * sh[:, 14] + SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15])
    return (out + 0.5).clamp_min(0.0)


def project(leaves: Dict[str, torch.Tensor], cam, s: dict, dtype, with_layout=True) -> tuple:
    """(Splats2D, Layout) of one camera (Layout None without `with_layout`).
    `leaves` may need gradients; every quantity is computed in `dtype`."""
    def d(x):
        return x.to(dtype)

    view = cam.viewmat.to(leaves["means"].device)
    rot, t = d(view[:3, :3]), d(view[:3, 3])
    means, scales = d(leaves["means"]), torch.exp(d(leaves["log_scales"]))
    op = torch.sigmoid(d(leaves["opacity_logits"]))
    p = means @ rot.T + t
    x, y, z = p.unbind(-1)
    in_front = z > s["near_plane"]
    zs = torch.where(in_front, z, torch.ones_like(z))

    m = rot @ _rotation(d(leaves["quats"])) * scales[:, None, :]  # W·R·S
    cov3 = m @ m.transpose(-1, -2)
    fx, fy = cam.fx, cam.fy
    lim_x, lim_y = 1.3 * 0.5 * cam.width / fx, 1.3 * 0.5 * cam.height / fy
    tx = (x / zs).clamp(-lim_x, lim_x) * zs
    ty = (y / zs).clamp(-lim_y, lim_y) * zs
    zero = torch.zeros_like(zs)
    jac = torch.stack([
        torch.stack([fx / zs, zero, -fx * tx / (zs * zs)], -1),
        torch.stack([zero, fy / zs, -fy * ty / (zs * zs)], -1),
    ], -2)
    cov2 = jac @ cov3 @ jac.transpose(-1, -2)
    ca = cov2[:, 0, 0] + s["cov2d_dilation"]
    cb = cov2[:, 0, 1]
    cc = cov2[:, 1, 1] + s["cov2d_dilation"]
    det = ca * cc - cb * cb
    det_ok = det > 1e-10
    det_safe = torch.where(det_ok, det, torch.ones_like(det))
    conic_a, conic_b, conic_c = cc / det_safe, -cb / det_safe, ca / det_safe

    log_skip = f32(math.log(s["alpha_skip"]))
    cutoff = 0.5 * s["sigma_extent"] ** 2
    bound = (torch.log(op.clamp_min(1e-30)) - log_skip).clamp_max(cutoff)
    if not s["opacity_aware_extent"]:
        raise ValueError("the reference holds the opacity-aware extent only")
    reach = bound.clamp_min(0.0)
    mx = fx * x / zs + cam.cx
    my = fy * y / zs + cam.cy
    rx = torch.sqrt(2.0 * reach * ca.clamp_min(0.0))
    ry = torch.sqrt(2.0 * reach * cc.clamp_min(0.0))
    on_screen = (mx + rx > 0) & (mx - rx < cam.width) & (my + ry > 0) & (my - ry < cam.height)
    valid = (in_front & det_ok & on_screen & (bound > 0)).detach()
    bound = torch.where(valid, bound, torch.full_like(bound, -1.0))

    cam_pos = -(rot.T @ t)
    dirs = means - cam_pos
    dirs = dirs / torch.sqrt((dirs * dirs).sum(-1, keepdim=True)).clamp_min(1e-8)
    colour = _sh_colour(d(leaves["sh"]), dirs, s["sh_degree"])

    layout = None
    if with_layout:
        layout = _layout(leaves["means"].detach().to(torch.float32), view, valid, mx.detach(),
                         my.detach(), rx.detach(), ry.detach(), cam)
    splats = Splats2D(mx, my, conic_a, conic_b, conic_c, op, bound.detach(),
                      colour[:, 0], colour[:, 1], colour[:, 2])
    return splats, layout


def _layout(means32, view, valid, mx, my, rx, ry, cam) -> Layout:
    """Depth ranks on the float32 camera z, and each splat's pixel box."""
    w = view.to(torch.float32)
    z32 = ((means32[:, 0] * w[2, 0] + means32[:, 1] * w[2, 1]) + means32[:, 2] * w[2, 2]) + w[2, 3]
    key = torch.where(valid, z32, torch.full_like(z32, math.inf))
    order = torch.argsort(key, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device)
    margin = 1e-3  # pixels: the box need only hold the ellipse
    mx, my = mx.to(ACC), my.to(ACC)
    rx, ry = rx.to(ACC) + margin, ry.to(ACC) + margin
    x0 = torch.ceil(mx - rx - 0.5).clamp(0, cam.width - 1).long()
    x1 = torch.floor(mx + rx - 0.5).clamp(-1, cam.width - 1).long()
    y0 = torch.ceil(my - ry - 0.5).clamp(0, cam.height - 1).long()
    y1 = torch.floor(my + ry - 0.5).clamp(-1, cam.height - 1).long()
    x1 = torch.where(valid, x1, x0 - 1)
    return Layout(valid, rank, x0, x1, y0, y1)


def bands(layout: Layout, height: int, budget: int = FRAGMENTS_PER_BAND):
    """Row bands [r0, r1), whole tile rows each, of at most about `budget`
    fragments (one tile row may hold more)."""
    wx = (layout.x1 - layout.x0 + 1).clamp_min(0)
    live = (wx > 0) & (layout.y1 >= layout.y0)
    per_row = torch.zeros(height + 1, dtype=torch.int64, device=wx.device)
    per_row.index_add_(0, layout.y0[live], wx[live])
    per_row.index_add_(0, layout.y1[live] + 1, -wx[live])
    per_row = per_row.cumsum(0)[:height]
    tile_rows = per_row.split(TILE_H)
    per_tile_row = [int(r.sum()) for r in tile_rows]
    out, start, acc = [], 0, 0
    for i, n in enumerate(per_tile_row):
        if acc and acc + n > budget:
            out.append((start, i * TILE_H))
            start, acc = i * TILE_H, 0
        acc += n
    out.append((start, height))
    return out


def _fragments(layout: Layout, r0: int, r1: int, width: int):
    """Fragments of the band's rows, sorted by (pixel, depth rank):
    (splat index, pixel x, pixel y) int64 each."""
    y0, y1 = layout.y0.clamp_min(r0), layout.y1.clamp_max(r1 - 1)
    wx = (layout.x1 - layout.x0 + 1).clamp_min(0)
    hy = (y1 - y0 + 1).clamp_min(0)
    count = wx * hy
    sel = torch.nonzero(count > 0).squeeze(1)
    cnt = count[sel]
    total = int(cnt.sum())
    dev = sel.device
    local = torch.repeat_interleave(torch.arange(sel.shape[0], device=dev), cnt, output_size=total)
    first = torch.cumsum(cnt, 0) - cnt
    off = torch.arange(total, device=dev) - first[local]
    splat = sel[local]
    px = layout.x0[splat] + off % wx[splat]
    py = y0[splat] + off // wx[splat]
    n = layout.rank.shape[0]
    key = ((py - r0) * width + px) * n + layout.rank[splat]
    order = torch.argsort(key)
    return splat[order], px[order], py[order]


def composite_band(feat: Splats2D, layout: Layout, frag, r0: int, r1: int, width: int,
                   alpha_clamp: float, counts: bool = False):
    """The band's (rows·W, 3) colour and (rows·W,) T_final in float64, from
    the per-splat features `feat` (differentiable) and fragments `frag`;
    with `counts`, also the band's tile counts (`_tile_counts`)."""
    splat, px, py = frag
    dev = splat.device
    npix = (r1 - r0) * width
    pix = (py - r0) * width + px
    dx = (px.to(feat.mx.dtype) + 0.5) - feat.mx[splat]
    dy = (py.to(feat.mx.dtype) + 0.5) - feat.my[splat]
    sigma = 0.5 * feat.a[splat] * dx * dx + feat.b[splat] * dx * dy + 0.5 * feat.c[splat] * dy * dy
    keep = (sigma >= 0) & (sigma <= feat.bound[splat])
    # the clamp is applied in the sums' precision: 0.999 is no bfloat16 value
    alpha = torch.where(keep, feat.op[splat] * torch.exp(-sigma),
                        torch.zeros_like(sigma)).to(ACC).clamp_max(alpha_clamp)
    log_t = torch.log1p(-alpha)
    csum = torch.cumsum(log_t, 0)
    pos = torch.arange(pix.shape[0], device=dev)
    start = torch.ones_like(pix, dtype=torch.bool)
    start[1:] = pix[1:] != pix[:-1]
    first = torch.cummax(torch.where(start, pos, torch.zeros_like(pos)), 0).values
    before = torch.where(first > 0, csum[(first - 1).clamp_min(0)], torch.zeros_like(csum))
    excl = csum - log_t - before  # log T in front of each fragment
    weight = torch.exp(excl) * alpha
    colour = torch.stack([feat.r[splat], feat.g[splat], feat.bl[splat]], -1).to(ACC)
    rgb = torch.zeros((npix, 3), dtype=ACC, device=dev).index_add(0, pix, weight[:, None] * colour)
    t_final = torch.exp(torch.zeros(npix, dtype=ACC, device=dev).index_add(0, pix, log_t))
    info = None
    if counts:
        with torch.no_grad():
            info = _tile_counts(layout.rank[splat], px, py, keep.detach(),
                                (excl + log_t).detach(), pix, r0, r1, width)
    return rgb, t_final, info


INF = 1 << 62


def _tile_counts(rank, px, py, keep, log_t_after, pix, r0, r1, width):
    """(pairs, steps, kept_steps) that a tile rasteriser needs for the band.
    A (splat, tile) pair is needed where one of its fragments is kept. A
    tile walks its needed pairs front to back until every one of its pixels
    has T below TRANSMITTANCE_EPS; a step is a (pixel in the image, walked
    pair), a kept step one that passes the keep test."""
    dev = rank.device
    npix = (r1 - r0) * width
    tiles_x = -(-width // TILE_W)
    ntiles = tiles_x * -(-(r1 - r0) // TILE_H)
    tile = ((py - r0) // TILE_H) * tiles_x + px // TILE_W
    # each pixel saturates at the first splat behind which T < eps
    sat = torch.full((npix,), INF, dtype=torch.int64, device=dev)
    hit = log_t_after < math.log(TRANSMITTANCE_EPS)
    sat.scatter_reduce_(0, pix[hit], rank[hit], "amin")
    ys = torch.arange(r0, r1, device=dev).repeat_interleave(width)
    xs = torch.arange(width, device=dev).repeat(r1 - r0)
    pix_tile = ((ys - r0) // TILE_H) * tiles_x + xs // TILE_W
    tile_exit = torch.full((ntiles,), -1, dtype=torch.int64, device=dev)
    tile_exit.scatter_reduce_(0, pix_tile, sat, "amax")
    tile_pixels = torch.bincount(pix_tile, minlength=ntiles)
    pair = torch.unique(tile[keep] * (1 << 40) + rank[keep])
    pair_tile, pair_rank = pair >> 40, pair & ((1 << 40) - 1)
    walked = pair_rank <= tile_exit[pair_tile]
    return {
        "pairs": int(pair.shape[0]),
        "steps": int(tile_pixels[pair_tile[walked]].sum()),
        "kept_steps": int((keep & (rank <= tile_exit[tile])).sum()),
    }


def _rect_counts(layout: Layout, small_tiles: int = 6) -> dict:
    """Tile cells of the splats' boxes (`cells`) and the splats whose box
    covers more than `small_tiles` tiles (`big_rows`)."""
    live = (layout.x1 >= layout.x0) & (layout.y1 >= layout.y0)
    w = torch.where(live, layout.x1 // TILE_W - layout.x0 // TILE_W + 1, 0)
    h = torch.where(live, layout.y1 // TILE_H - layout.y0 // TILE_H + 1, 0)
    area = w * h
    return {"cells": int(area.sum()), "big_rows": int((area > small_tiles).sum())}


def render(leaves: Dict[str, torch.Tensor], cam, s: dict, dtype=ACC, counts=False,
           background=None, projected=None):
    """(image (H, W, 3) float64, tile counts or None) of one camera from
    float32 leaves; `projected` may be an earlier `project` of them."""
    feat, layout = projected if projected is not None else project(leaves, cam, s, dtype)
    h, w = cam.height, cam.width
    dev = layout.rank.device
    rgb = torch.empty((h * w, 3), dtype=ACC, device=dev)
    t_final = torch.empty((h * w,), dtype=ACC, device=dev)
    totals = {"pairs": 0, "steps": 0, "kept_steps": 0}
    for r0, r1 in bands(layout, h):
        frag = _fragments(layout, r0, r1, w)
        band_rgb, band_t, info = composite_band(feat, layout, frag, r0, r1, w,
                                                s["alpha_clamp"], counts)
        rgb[r0 * w:r1 * w] = band_rgb
        t_final[r0 * w:r1 * w] = band_t
        for k in (info or {}):
            totals[k] += info[k]
    if counts:
        totals.update(_rect_counts(layout))
    bg = s["background"] if background is None else background
    image = rgb + t_final[:, None] * torch.tensor(bg, dtype=ACC, device=dev)
    return image.view(h, w, 3), (totals if counts else None)


def to_uint8(image: torch.Tensor) -> torch.Tensor:
    """What a viewer shows: round half up, clamped to [0, 255]."""
    return torch.floor((image * 255.0 + 0.5).clamp(0.0, 255.0)).to(torch.uint8)
