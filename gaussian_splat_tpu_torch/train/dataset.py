"""Multi-view training data: (camera, image) pairs with random view sampling.

Counterpart of gaussian_splat_tpu/train/dataset.py. Images are stacked once
into a tensor on the training device; the cameras share intrinsics and
resolution and differ in their view matrix.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from gaussian_splat_tpu_torch._device import DeviceLike
from gaussian_splat_tpu_torch.camera import Camera, orbit_camera


@dataclasses.dataclass
class ViewDataset:
    """Stacked posed views. All cameras share (fx, fy, cx, cy, W, H)."""

    viewmats: torch.Tensor  # (V, 4, 4)
    images: torch.Tensor  # (V, H, W, 3) float32 in [0,1]
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int
    height: int

    @classmethod
    def from_views(
        cls, views: Sequence[Tuple[Camera, np.ndarray]], device: DeviceLike = None
    ) -> "ViewDataset":
        """`views` holds (camera, (H, W, 3) image) pairs; an image may be a
        numpy array or a tensor. `device` defaults to the cameras' device."""
        cams = [c for c, _ in views]
        device = cams[0].device if device is None else torch.device(device)
        w, h = cams[0].width, cams[0].height
        for c in cams:
            if (c.width, c.height) != (w, h):
                raise ValueError(
                    f"all views must share resolution: {(c.width, c.height)} vs {(w, h)}"
                )
        first = cams[0].to(device)
        return cls(
            viewmats=torch.stack([c.viewmat.to(device) for c in cams]),
            images=torch.stack([
                torch.as_tensor(img, dtype=torch.float32).detach().to(device)
                for _, img in views
            ]),
            fx=first.fx, fy=first.fy, cx=first.cx, cy=first.cy,
            width=w, height=h,
        )

    @property
    def num_views(self) -> int:
        return self.images.shape[0]

    @property
    def device(self) -> torch.device:
        return self.images.device

    def camera(self, i: int) -> Camera:
        return Camera(
            viewmat=self.viewmats[i],
            fx=self.fx, fy=self.fy, cx=self.cx, cy=self.cy,
            width=self.width, height=self.height,
        )

    def target(self, i: int) -> torch.Tensor:
        return self.images[i]


def orbit_dataset(
    render_fn,
    n_views: int = 8,
    radius: float = 4.0,
    elevation_deg: float = 20.0,
    width: int = 256,
    height: int = 256,
    fov_y_deg: float = 50.0,
    device: DeviceLike = None,
) -> ViewDataset:
    """Synthesize a turntable dataset by rendering `render_fn(camera)` — used
    in tests and smoke runs to create ground-truth multi-view sets."""
    views = []
    for i in range(n_views):
        cam = orbit_camera(
            radius, 360.0 * i / n_views, elevation_deg,
            fov_y_deg=fov_y_deg, width=width, height=height, device=device,
        )
        with torch.no_grad():
            views.append((cam, render_fn(cam)))
    return ViewDataset.from_views(views)
