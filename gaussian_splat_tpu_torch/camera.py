"""Camera model: intrinsics + world→camera extrinsics, plus lookat helpers.

Counterpart of gaussian_splat_tpu/camera.py. Convention: OpenCV-style camera
space — +x right, +y down, +z forward, so a point in front of the camera has
z > 0. A pixel (i, j) has its center at (j + 0.5, i + 0.5);
`mean2d = (fx·x/z + cx, fy·y/z + cy)`.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gaussian_splat_tpu_torch._device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera. `viewmat` is the (4,4) world→camera transform (OpenCV
    axes); the intrinsics are 0-d float32 tensors on the same device.
    `width`/`height` are static Python ints."""

    viewmat: torch.Tensor  # (4, 4) float32, world -> camera
    fx: torch.Tensor  # focal length in pixels
    fy: torch.Tensor
    cx: torch.Tensor  # principal point in pixels
    cy: torch.Tensor
    width: int
    height: int

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_fov(
        cls,
        viewmat,
        fov_y_deg: float,
        width: int,
        height: int,
        device: DeviceLike = None,
    ) -> "Camera":
        """Vertical-FOV constructor: fy = (H/2) / tan(fov_y/2), square pixels."""
        device = resolve_device(device)
        fov_y = math.radians(fov_y_deg)
        fy = 0.5 * height / math.tan(0.5 * fov_y)

        def scalar(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return cls(
            viewmat=torch.as_tensor(viewmat, dtype=torch.float32).to(device),
            fx=scalar(fy),
            fy=scalar(fy),
            cx=scalar(width / 2.0),
            cy=scalar(height / 2.0),
            width=int(width),
            height=int(height),
        )

    @classmethod
    def from_lookat(
        cls,
        eye,
        target,
        up,
        fov_y_deg: float,
        width: int,
        height: int,
        device: DeviceLike = None,
    ) -> "Camera":
        device = resolve_device(device)
        return cls.from_fov(look_at(eye, target, up), fov_y_deg, width, height, device)

    # -- derived quantities ------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.viewmat.device

    @property
    def rotation(self) -> torch.Tensor:
        return self.viewmat[:3, :3]

    @property
    def translation(self) -> torch.Tensor:
        return self.viewmat[:3, 3]

    @property
    def position(self) -> torch.Tensor:
        """Camera center in world coordinates (−Rᵀ t)."""
        return -self.rotation.T @ self.translation

    def resized(self, width: int, height: int) -> "Camera":
        """Scale intrinsics to a new viewport."""
        sx = width / self.width
        sy = height / self.height
        return Camera(
            viewmat=self.viewmat,
            fx=self.fx * sx,
            fy=self.fy * sy,
            cx=self.cx * sx,
            cy=self.cy * sy,
            width=int(width),
            height=int(height),
        )

    def to(self, device: DeviceLike) -> "Camera":
        device = torch.device(device)
        return Camera(
            self.viewmat.to(device), self.fx.to(device), self.fy.to(device),
            self.cx.to(device), self.cy.to(device), self.width, self.height,
        )


def look_at(eye, target, up) -> torch.Tensor:
    """World→camera matrix in the OpenCV convention (+z toward target).

    A (4,4) float32 tensor built on the host (twelve numbers of float32
    arithmetic, in the reference's order of operations); the Camera
    constructors move it to their device."""
    eye = torch.as_tensor(eye, dtype=torch.float32).cpu()
    target = torch.as_tensor(target, dtype=torch.float32).cpu()
    up = torch.as_tensor(up, dtype=torch.float32).cpu()

    fwd = target - eye
    fwd = fwd / torch.linalg.norm(fwd)
    right = torch.linalg.cross(fwd, up)
    right = right / torch.linalg.norm(right)
    down = torch.linalg.cross(fwd, right)  # +y is down in OpenCV camera space

    R = torch.stack([right, down, fwd], dim=0)  # (3,3) world->cam rotation
    viewmat = torch.eye(4, dtype=torch.float32)
    viewmat[:3, :3] = R
    viewmat[:3, 3] = -R @ eye
    return viewmat


def orbit_camera(
    radius: float,
    azimuth_deg: float,
    elevation_deg: float,
    target=(0.0, 0.0, 0.0),
    fov_y_deg: float = 45.0,
    width: int = 1280,
    height: int = 720,
    device: DeviceLike = None,
) -> Camera:
    """Convenience orbit constructor around `target`."""
    az = math.radians(azimuth_deg)
    el = math.radians(elevation_deg)
    tx, ty, tz = target
    eye = (
        tx + radius * math.cos(el) * math.sin(az),
        ty + radius * math.sin(el),
        tz + radius * math.cos(el) * math.cos(az),
    )
    return Camera.from_lookat(
        eye, target, (0.0, 1.0, 0.0), fov_y_deg, width, height, device
    )
