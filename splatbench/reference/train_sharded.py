"""Plain PyTorch reference of training steps over ranks of a process group,
for a scene whose float64 state does not fit one card: the semantics of
splatbench/reference/train.py, with the splats split over the ranks.

Like the one-process reference it imports nothing of the program, and it
makes its own `torch.distributed` calls on the group it is handed. Rank r of
D holds rows [r·N/D, (r+1)·N/D) of the leaves in `param_dtype` and their
Adam moments. A step, on every rank:

  1. projects its own rows (splatbench/reference/render.py's `project`);
  2. gathers every rank's screen features, pixel boxes, valid flags and
     float32 depth keys, so that it holds the whole scene's; the depth rank
     is the argsort of the gathered keys (ties to the lower row, as in one
     process);
  3. composites its own band of pixel rows, [r·B, (r+1)·B) with B the
     frame's 16-row tile rows split D ways, in the reference's fragment
     bands, without a graph, and gathers the bands into the whole frame;
  4. computes the loss on the whole frame (the same on every rank) and its
     gradient with respect to the image;
  5. composites its band again with a graph and pulls its rows of that
     gradient back onto the gathered features: every rank's share of each
     splat's feature gradient;
  6. sums those shares over the ranks with a reduce-scatter, so that each
     rank gets the whole gradient of its own rows' features, and pulls it
     back through its own rows' projection onto its leaves;
  7. takes an Adam step on its own leaves.

This is the simplest split that fits: one gather of the features a step
(10 numbers a splat in the working precision, 5 integers and a key) and one
reduce-scatter of their gradient, both of the whole scene, and no process
ever holds another rank's leaves or moments. Compositing is per pixel, so
the bands change only the rounding of the fragment prefix sums (~1e-16 of
a band's log-transmittance sum). Norms (of the first gradient, of the
change) are summed over the ranks.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.distributed as dist

from splatbench.reference import render as ref
from splatbench.reference import train as ref_train

LEAVES = ref_train.LEAVES


def _gather(t: torch.Tensor, group) -> torch.Tensor:
    out = t.new_empty((dist.get_world_size(group) * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def band_rows(height: int, rank: int, world: int):
    """This rank's pixel rows [r0, r1) and the rows a band holds: the
    frame's 16-row tile rows split D ways."""
    tile_rows = -(-height // ref.TILE_H)
    per = -(-tile_rows // world) * ref.TILE_H
    return min(rank * per, height), min((rank + 1) * per, height), per


def _depth_key(means: torch.Tensor, view: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The float32 camera z of render.py's layout, inf where not drawn."""
    m, w = means.detach().to(torch.float32), view.to(torch.float32)
    z32 = ((m[:, 0] * w[2, 0] + m[:, 1] * w[2, 1]) + m[:, 2] * w[2, 2]) + w[2, 3]
    return torch.where(valid, z32, torch.full_like(z32, math.inf))


def whole_scene(block: Dict[str, torch.Tensor], cam, s: dict, dtype, group):
    """(gathered features (N, 10), whole-scene Layout) from this rank's rows."""
    feat, local = ref.project(block, cam, s, dtype)
    view = cam.viewmat.to(block["means"].device)
    boxes = torch.stack([local.valid.long(), local.x0, local.x1, local.y0, local.y1], -1)
    feats = _gather(feat.stacked().detach(), group)
    boxes = _gather(boxes, group)
    key = _gather(_depth_key(block["means"], view, local.valid), group)
    order = torch.argsort(key, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device)
    valid, x0, x1, y0, y1 = boxes.unbind(-1)
    return feats, ref.Layout(valid.bool(), rank, x0, x1, y0, y1)


def _sub_bands(layout: ref.Layout, height: int, r0: int, r1: int):
    """The reference's fragment bands cut to rows [r0, r1)."""
    cut = [(max(a, r0), min(b, r1)) for a, b in ref.bands(layout, height)]
    return [(a, b) for a, b in cut if a < b]


def loss_and_grads(block: Dict[str, torch.Tensor], cam, target: torch.Tensor, s: dict,
                   dtype, ssim_weight: float, group):
    """(loss, {leaf: gradient of this rank's rows}) of one view."""
    world, me = dist.get_world_size(group), dist.get_rank(group)
    h, w = cam.height, cam.width
    r0, r1, per = band_rows(h, me, world)
    with torch.no_grad():
        feats, layout = whole_scene(block, cam, s, dtype, group)
    leaf = ref.Splats2D(*feats.unbind(-1))
    dev = feats.device
    bg = torch.tensor(s["background"], dtype=ref.ACC, device=dev)
    mine = _sub_bands(layout, h, r0, r1)

    band = torch.zeros((per * w, 3), dtype=ref.ACC, device=dev)
    with torch.no_grad():
        for a, b in mine:
            frag = ref._fragments(layout, a, b, w)
            rgb, t_final, _ = ref.composite_band(leaf, layout, frag, a, b, w, s["alpha_clamp"])
            band[(a - r0) * w:(b - r0) * w] = rgb + t_final[:, None] * bg
    image = _gather(band, group)[:h * w].view(h, w, 3)

    loss_dtype = torch.promote_types(dtype, torch.float32)
    img = image.to(loss_dtype).requires_grad_()
    loss = ref_train.photometric_loss(img, target.to(loss_dtype), ssim_weight)
    (d_img,) = torch.autograd.grad(loss, img)
    d_img = d_img.to(ref.ACC).reshape(-1, 3)

    stacked = feats.requires_grad_()
    leaf = ref.Splats2D(*stacked.unbind(-1))
    for a, b in mine:
        frag = ref._fragments(layout, a, b, w)
        rgb, t_final, _ = ref.composite_band(leaf, layout, frag, a, b, w, s["alpha_clamp"])
        (rgb + t_final[:, None] * bg).backward(d_img[a * w:b * w])
    shares = stacked.grad if stacked.grad is not None else torch.zeros_like(feats)
    del stacked, leaf, feats, layout
    n = block["means"].shape[0]
    d_feat = shares.new_empty((n, shares.shape[1]))
    dist.reduce_scatter_tensor(d_feat, shares.contiguous(), group=group)
    del shares

    grads = {k: torch.zeros_like(v) for k, v in block.items()}
    for a in range(0, n, ref_train.PROJECT_ROWS):
        b = min(a + ref_train.PROJECT_ROWS, n)
        rows = {k: v[a:b].detach().requires_grad_() for k, v in block.items()}
        f, _ = ref.project(rows, cam, s, dtype, with_layout=False)
        torch.autograd.backward(f.stacked(), d_feat[a:b].to(f.mx.dtype))
        for k in block:
            grads[k][a:b] = rows[k].grad
    return float(loss.detach()), grads


def global_norm(t: torch.Tensor, group) -> float:
    """The norm of a tensor whose rows are split over the ranks."""
    sq = torch.linalg.vector_norm(t.to(ref.ACC)).square().reshape(1)
    dist.all_reduce(sq, group=group)
    return float(sq.sqrt())


def train(block0: Dict[str, torch.Tensor], cams, targets: torch.Tensor, views, s: dict,
          tc: dict, group, dtype=ref.ACC, param_dtype=ref.ACC) -> dict:
    """Steps from this rank's rows `block0` on `views`, on every rank of
    `group`: each step's loss, the first gradient's norm per leaf (over all
    rows), and this rank's rows after the last step (`param_dtype`)."""
    params = {k: block0[k].detach().to(param_dtype).clone() for k in LEAVES}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2, eps = tc["adam_betas"][0], tc["adam_betas"][1], tc["adam_eps"]
    lrs = {"quats": tc["lr_quats"], "log_scales": tc["lr_scales"],
           "opacity_logits": tc["lr_opacities"], "sh": tc["lr_sh"]}
    losses, grad_norms = [], None
    for t, view in enumerate(views, start=1):
        loss, grads = loss_and_grads(params, cams[view], targets[view], s, dtype,
                                     tc["ssim_weight"], group)
        losses.append(loss)
        if grad_norms is None:
            grad_norms = {k: global_norm(g, group) for k, g in grads.items()}
        lrs["means"] = ref_train.position_lr(tc, tc["start_step"] + t - 1)
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        with torch.no_grad():
            for k in LEAVES:
                g = grads[k].to(param_dtype)
                m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = v2[k].sqrt() / math.sqrt(bc2) + eps
                params[k].addcdiv_(m[k], denom, value=-lrs[k] / bc1)
        del grads
    return {"losses": losses, "grad_norms": grad_norms, "params": params}
