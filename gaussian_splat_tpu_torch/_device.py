"""Device resolution shared by every entry point that creates tensors."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means the GPU. With no GPU present that RAISES — the port never
    falls back to the CPU on its own; callers (the tests) ask for it by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: gaussian_splat_tpu_torch runs on the "
                'GPU by default; pass device="cpu" explicitly to run on the CPU'
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def require_device(actual: torch.device, device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on (`device`, None: the GPU), which the
    data it was handed (lying on `actual`) must be on already."""
    want = resolve_device(device)
    if want.type != actual.type or (
        want.index is not None and actual.index is not None and want.index != actual.index
    ):
        raise ValueError(f"runs on {want}, but its data lies on {actual}")
    return want
