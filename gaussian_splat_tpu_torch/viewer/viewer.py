"""Headless frame server: device-rendered frames + live metrics.

Counterpart of gaussian_splat_tpu/viewer/viewer.py.

  * `Viewer.render_frame()` — one camera→uint8 image step with frame timing,
    in color / depth / alpha modes.
  * `Viewer.orbit_turntable()` — offline turntable render (frames or PNG dir).

Still to come, each raising NotImplementedError here: the grid/axes overlay,
kernel hot reload, level-of-detail subsets while dragging, and the MJPEG HTTP
server `serve()`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gaussian_splat_tpu_torch._device import DeviceLike, resolve_device
from gaussian_splat_tpu_torch.camera import Camera, orbit_camera
from gaussian_splat_tpu_torch.config import RenderConfig
from gaussian_splat_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_tpu_torch.ops.render import render
from gaussian_splat_tpu_torch.utils.timing import ScopeTimer
from gaussian_splat_tpu_torch.viewer.trackball import TrackballCamera


def to_uint8(image: torch.Tensor) -> np.ndarray:
    return torch.clamp(image * 255.0 + 0.5, 0, 255).to(torch.uint8).cpu().numpy()


class Viewer:
    """Serves frames of `model` on `device` (None: the GPU), where the model
    must already lie."""

    def __init__(
        self,
        model: GaussianModel,
        config: RenderConfig = RenderConfig(),
        width: int = 1280,
        height: int = 720,
        overlay_objects: Optional[list] = None,
        show_overlay: bool = True,
        hot_reload: bool = False,
        background=(0.1, 0.1, 0.15),
        lod_fraction: float = 0.0,
        lod_pair_budget: float = 0.0,
        device: DeviceLike = None,
    ):
        if show_overlay or overlay_objects:
            raise NotImplementedError(
                "grid/axes overlay: viewer-overlay slice (pass show_overlay=False)"
            )
        if hot_reload:
            raise NotImplementedError("kernel hot reload: hot-reload slice")
        if lod_fraction > 0.0 or lod_pair_budget > 0.0:
            raise NotImplementedError("drag level-of-detail: LoD slice")
        self.device = resolve_device(device)
        if self.device.type != model.device.type:
            raise ValueError(
                f"viewer runs on {self.device}, model is on {model.device}"
            )
        self.model = model
        self.config = config
        self.width = width
        self.height = height
        self.mode = "color"  # "color" | "depth" | "alpha" debug views
        self.background = background
        self.show_overlay = False
        self.trackball = TrackballCamera()
        self.timers = ScopeTimer(self.device)
        self.last_output = None  # RenderOutput of the newest frame (over black)
        # splats are rendered over BLACK so T_final carries the residual for
        # the background composite
        self._render_config = dataclasses.replace(config, background=(0.0, 0.0, 0.0))
        self._background = torch.tensor(
            background, dtype=torch.float32, device=self.device
        )

    # -- single frame --------------------------------------------------------
    @torch.no_grad()
    def render_frame(self, camera: Optional[Camera] = None) -> np.ndarray:
        cam = camera or self.trackball.camera(self.width, self.height, self.device)
        with self.timers.scope("frame"):
            out = render(self.model, cam, self._render_config)
        self.last_output = out
        image, alpha, depth = out.image, out.alpha, out.depth
        if self.mode == "color":
            image = image + (1.0 - alpha)[..., None] * self._background
        elif self.mode == "alpha":
            image = alpha[..., None].expand(-1, -1, 3)
        elif self.mode == "depth":
            # normalized inverse-depth heat view (near = bright)
            d = depth / torch.clamp_min(alpha, 1e-6)
            inv = torch.where(alpha > 0.05, 1.0 / torch.clamp_min(d, 1e-3), 0.0)
            inv = inv / torch.clamp_min(inv.max(), 1e-6)
            image = torch.stack([inv, inv * 0.6, 1.0 - inv], dim=-1) * (
                alpha[..., None] > 0.05
            )
        return to_uint8(image)

    @property
    def last_stats(self):
        """BinningStats of the newest frame (None before the first)."""
        return None if self.last_output is None else self.last_output.stats

    def resize(self, width: int, height: int) -> None:
        """Change the viewport; externally-supplied cameras can use
        `Camera.resized` for the same intrinsics scaling."""
        self.width = max(16, int(width))
        self.height = max(16, int(height))

    def metrics(self) -> dict:
        frame = self.timers.stats.get("frame")
        ms = frame.mean if frame else 0.0
        return {
            "fps": 1000.0 / ms if ms > 0 else 0.0,
            "frame_ms": ms,
            "num_gaussians": self.model.num_gaussians,
            "resolution": [self.width, self.height],
            "camera_position": [float(v) for v in self.trackball.position],
        }

    # -- offline turntable ---------------------------------------------------
    def orbit_turntable(
        self,
        n_frames: int = 60,
        radius: float = 5.0,
        elevation_deg: float = 20.0,
        out_dir: Optional[str] = None,
    ):
        """Render an orbit; optionally save PNG frames. Returns the frames."""
        frames = []
        for i in range(n_frames):
            cam = orbit_camera(
                radius, 360.0 * i / n_frames, elevation_deg,
                width=self.width, height=self.height, device=self.device,
            )
            frames.append(self.render_frame(cam))
        if out_dir is not None:
            import os

            from PIL import Image

            os.makedirs(out_dir, exist_ok=True)
            for i, f in enumerate(frames):
                Image.fromarray(f).save(f"{out_dir}/frame_{i:04d}.png")
        return frames

    def serve(self, host: str = "127.0.0.1", port: int = 8000, block: bool = True):
        raise NotImplementedError("MJPEG HTTP viewer: HTTP-serve slice")
