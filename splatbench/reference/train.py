"""Plain PyTorch reference of training steps: the 3DGS photometric loss,
gradients through splatbench/reference/render.py by autograd, and Adam.

Like the renderer it imports nothing of the program. Gradients are taken in
two passes so that a large scene fits: the image is rendered without a graph,
the loss's gradient with respect to the image is taken, then each row band's
compositing is run again with a graph and pulled back onto the per-splat
screen features, and the projection is run again in blocks of splats and
pulled back onto the five leaves. The result is autograd's gradient of the
whole frame, computed in pieces.

Loss: (1 − w)·L1 + w·(1 − SSIM), SSIM over an 11×11 Gaussian window of
σ = 1.5 with zero padding, data range 1 (Wang et al. 2004, as 3DGS uses
it). Adam (Kingma and Ba 2015): m ← β1·m + (1 − β1)·g, v ← β2·v + (1 −
β2)·g², θ ← θ − lr/(1 − β1ᵗ) · m / (√v / √(1 − β2ᵗ) + eps); the means'
lr decays log-linearly from `lr_means` to `lr_means_final` over
`lr_decay_steps` updates (3DGS's position schedule), counted from
`start_step`.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from splatbench.reference import render as ref

LEAVES = ("means", "quats", "log_scales", "opacity_logits", "sh")
PROJECT_ROWS = 1 << 21


def gaussian_window(size: int = 11, sigma: float = 1.5) -> List[float]:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return list(g / g.sum())


def _blur(x: torch.Tensor, window: List[float]) -> torch.Tensor:
    """Separable filter of an (H, W, C) image with zero padding, SAME size."""
    pad = len(window) // 2
    h, w, _ = x.shape
    xp = F.pad(x, (0, 0, 0, 0, pad, pad))
    x = sum(wk * xp[k:k + h] for k, wk in enumerate(window))
    xp = F.pad(x, (0, 0, pad, pad))
    return sum(wk * xp[:, k:k + w] for k, wk in enumerate(window))


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    win = gaussian_window()
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu_a, mu_b = _blur(a, win), _blur(b, win)
    var_a = _blur(a * a, win) - mu_a * mu_a
    var_b = _blur(b * b, win) - mu_b * mu_b
    cov = _blur(a * b, win) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2))
    return s.mean()


def photometric_loss(pred: torch.Tensor, target: torch.Tensor, w: float) -> torch.Tensor:
    l1 = (pred - target).abs().mean()
    return (1.0 - w) * l1 + w * (1.0 - ssim(pred, target))


def position_lr(tc: dict, count: int) -> float:
    lr0, lr1 = tc["lr_means"], tc["lr_means_final"]
    rate = lr1 / lr0
    lr = lr0 * math.pow(rate, count / tc["lr_decay_steps"])
    return max(lr, lr1) if rate < 1.0 else min(lr, lr1)


def loss_and_grads(params: Dict[str, torch.Tensor], cam, target: torch.Tensor, s: dict,
                   dtype, ssim_weight: float, counts: bool = False):
    """(loss, {leaf: gradient}, tile counts) of one view."""
    with torch.no_grad():
        feat, layout = ref.project(params, cam, s, dtype)
        image, info = ref.render(params, cam, s, dtype, counts=counts, projected=(feat, layout))
    # the image and the loss in float32 at least (bfloat16 sums overflow)
    loss_dtype = torch.promote_types(dtype, torch.float32)
    img = image.to(loss_dtype).requires_grad_()
    loss = photometric_loss(img, target.to(loss_dtype), ssim_weight)
    (d_img,) = torch.autograd.grad(loss, img)
    d_img = d_img.to(ref.ACC).reshape(-1, 3)

    # the compositing's gradient, band by band, onto the screen features
    stacked = feat.stacked().detach().requires_grad_()
    leaf_feat = ref.Splats2D(*stacked.unbind(-1))
    h, w = cam.height, cam.width
    bg = torch.tensor(s["background"], dtype=ref.ACC, device=stacked.device)
    for r0, r1 in ref.bands(layout, h):
        frag = ref._fragments(layout, r0, r1, w)
        rgb, t_final, _ = ref.composite_band(leaf_feat, layout, frag, r0, r1, w, s["alpha_clamp"])
        band = rgb + t_final[:, None] * bg
        band.backward(d_img[r0 * w:r1 * w])
    d_feat = stacked.grad
    del stacked, leaf_feat

    # the projection's gradient, block by block, onto the leaves
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    n = params["means"].shape[0]
    for a in range(0, n, PROJECT_ROWS):
        b = min(a + PROJECT_ROWS, n)
        block = {k: v[a:b].detach().requires_grad_() for k, v in params.items()}
        f, _ = ref.project(block, cam, s, dtype, with_layout=False)
        torch.autograd.backward(f.stacked(), d_feat[a:b].to(f.mx.dtype))
        for k in params:
            grads[k][a:b] = block[k].grad
    return float(loss.detach()), grads, info


def train(leaves0: Dict[str, torch.Tensor], cams, targets: torch.Tensor, views, s: dict,
          tc: dict, dtype=ref.ACC, param_dtype=ref.ACC, counts: bool = False) -> dict:
    """Steps from `leaves0` on `views` (indices into `cams`/`targets`):
    each step's loss, the first step's gradient norm per leaf, and the
    leaves after the last step (`param_dtype`)."""
    params = {k: leaves0[k].detach().to(param_dtype).clone() for k in LEAVES}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2, eps = tc["adam_betas"][0], tc["adam_betas"][1], tc["adam_eps"]
    lrs = {"quats": tc["lr_quats"], "log_scales": tc["lr_scales"],
           "opacity_logits": tc["lr_opacities"], "sh": tc["lr_sh"]}
    losses, grad_norms, step_counts = [], None, []
    for t, view in enumerate(views, start=1):
        loss, grads, info = loss_and_grads(params, cams[view], targets[view], s, dtype,
                                           tc["ssim_weight"], counts)
        losses.append(loss)
        step_counts.append(info)
        if grad_norms is None:
            grad_norms = {k: float(torch.linalg.vector_norm(g.to(ref.ACC)))
                          for k, g in grads.items()}
        lrs["means"] = position_lr(tc, tc["start_step"] + t - 1)
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        with torch.no_grad():
            for k in LEAVES:
                g = grads[k].to(param_dtype)
                m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = v2[k].sqrt() / math.sqrt(bc2) + eps
                params[k].addcdiv_(m[k], denom, value=-lrs[k] / bc1)
        del grads
    return {"losses": losses, "grad_norms": grad_norms, "params": params, "counts": step_counts}
