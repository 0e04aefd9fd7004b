"""Photometric losses: L1 + SSIM (the 3DGS training objective).

Counterpart of gaussian_splat_tpu/train/loss.py:
L = (1−λ)·L1 + λ·(1−SSIM) with λ = 0.2.

SSIM is the 11×11 Gaussian-windowed variant. The window is separable, so the
filter is two 1D passes of shifted multiply-adds on the (H, W, C) image, as
in the reference: plain float32 tensor code, differentiated by autograd. It
is deliberately not `F.conv2d`: a float32 convolution goes through cuDNN in
TF32 on the GPU by default (about three decimal digits), and the port flips no
global precision flag; the shift-add form is full float32 on every device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def _gaussian_window_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x**2) / (2 * sigma**2))
    g /= g.sum()
    return g.astype(np.float32)


def _filter2d(img: torch.Tensor, window1d: np.ndarray) -> torch.Tensor:
    """Separable Gaussian filter on (H, W, C), SAME zero padding: two 1D
    passes of `size` shifted multiply-adds each (slice-of-pad, no conv)."""
    size = int(window1d.shape[0])
    pad = size // 2
    h, w_, _ = img.shape

    def pass_along(x, axis, n):
        widths = [0, 0] * 3  # F.pad counts from the LAST axis
        widths[2 * (2 - axis)] = widths[2 * (2 - axis) + 1] = pad
        xp = F.pad(x, widths)
        acc = None
        for k in range(size):
            term = float(window1d[k]) * xp.narrow(axis, k, n)
            acc = term if acc is None else acc + term
        return acc

    return pass_along(pass_along(img, 0, h), 1, w_)


def ssim(a: torch.Tensor, b: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM over an (H, W, C) image pair, data range 1.0."""
    w = _gaussian_window_1d(window_size)
    c1 = 0.01**2
    c2 = 0.03**2

    mu_a = _filter2d(a, w)
    mu_b = _filter2d(b, w)
    mu_aa = mu_a * mu_a
    mu_bb = mu_b * mu_b
    mu_ab = mu_a * mu_b
    sigma_aa = _filter2d(a * a, w) - mu_aa
    sigma_bb = _filter2d(b * b, w) - mu_bb
    sigma_ab = _filter2d(a * b, w) - mu_ab

    s = ((2 * mu_ab + c1) * (2 * sigma_ab + c2)) / (
        (mu_aa + mu_bb + c1) * (sigma_aa + sigma_bb + c2)
    )
    return torch.mean(s)


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def photometric_loss(
    pred: torch.Tensor, target: torch.Tensor, ssim_weight: float = 0.2
) -> torch.Tensor:
    """(1−λ)·L1 + λ·(1−SSIM), the 3DGS objective."""
    if ssim_weight == 0.0:
        return l1(pred, target)
    return (1.0 - ssim_weight) * l1(pred, target) + ssim_weight * (
        1.0 - ssim(pred, target)
    )
