"""Shared per-splat falloff semantics: ONE definition for every backend.

Counterpart of gaussian_splat_tpu/ops/falloff.py. The dense oracle
(ops/reference.py), the torch tile compositor (ops/tile_raster.py) and the
CUDA kernel (csrc/raster_fwd.cu) must agree on the keep decision exactly:
parity is held at tolerances far below the α_skip step (1/255), so a pair that
crosses the skip/cutoff boundary in ONE implementation shows up as a ~4e-3
pixel error.

    σ      = 0.5·A·dx² + B·dx·dy + 0.5·C·dy²
    bound  = min(σ_cutoff, ln(op) − ln(α_skip))        (per GAUSSIAN, not per pixel)
    keep   = (σ ≥ 0) ∧ (σ ≤ bound)
    α      = keep ? min(op·e^(−σ), α_clamp) : 0

σ is evaluated as (A2·dx)·dx + (C2·dy + B·dx)·dy with A2 = 0.5A, C2 = 0.5C —
every multiply and add rounded on its own (eager torch ops do not contract to
FMA; the CUDA kernel spells the same order with __fmul_rn/__fadd_rn). `bound`
is computed once per splat HERE and handed to the kernel as a table column, so
no logarithm sits in the kernel's keep decision.

Invalid rows get bound = −1, unreachable since σ ≥ 0.
"""

from __future__ import annotations

import math
import struct

import torch

_TINY_OP = 1e-30  # log argument floor; real opacities are sigmoid outputs > 0


def log_alpha_skip(alpha_skip: float) -> float:
    """ln(α_skip) rounded to float32 (as the reference rounds it), returned as
    a Python float so that it joins float32 tensor arithmetic unchanged."""
    return struct.unpack("f", struct.pack("f", math.log(alpha_skip)))[0]


def sigma_bound(
    opacities: torch.Tensor,
    valid: torch.Tensor,
    sigma_cutoff: float,
    alpha_skip: float,
) -> torch.Tensor:
    """Per-gaussian σ acceptance bound: min(cutoff, ln(op/α_skip)); −1 if invalid.

    `opacities` and `valid` must be mutually broadcastable; the result
    broadcasts against σ. The subtrahend ln(α_skip) is rounded to float32
    first, as the reference rounds it."""
    log_skip = log_alpha_skip(alpha_skip)
    lop = torch.log(torch.clamp_min(opacities, _TINY_OP))
    bound = torch.clamp_max(lop - log_skip, sigma_cutoff)
    return torch.where(valid, bound, -1.0)


def sigma_quadform(dx, dy, A2, B, C2):
    """σ = (A2·dx)·dx + (C2·dy + B·dx)·dy with A2 = 0.5·A, C2 = 0.5·C.

    All backends MUST evaluate σ with this exact factorization — a different
    association rounds differently and flips keep-boundary pixels."""
    return (A2 * dx) * dx + (C2 * dy + B * dx) * dy


def alpha_from_sigma(sigma, opacities, bound, alpha_clamp: float):
    """(α, α_raw, keep) from the falloff argument. α is 0 outside keep."""
    keep = (sigma >= 0.0) & (sigma <= bound)
    alpha_raw = opacities * torch.exp(-sigma)
    alpha = torch.where(keep, torch.clamp_max(alpha_raw, alpha_clamp), 0.0)
    return alpha, alpha_raw, keep
