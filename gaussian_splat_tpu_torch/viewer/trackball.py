"""Trackball orbit camera — host-side control scheme of the viewer.

Own copy of gaussian_splat_tpu/viewer/trackball.py (pure numpy), emitting the
port's `Camera`:
  * rotate = quat about world-Y (horizontal drag) ∘ quat about camera-right
    (vertical drag), applied to both the eye offset and the up vector
  * pan in the camera plane, scaled by distance/viewportHeight
  * zoom: distance ·= 0.95^(delta·zoomSpeed), clamped to [0.1, 100]
  * tunables rotateSpeed/zoomSpeed/panSpeed and fov default 45°

`camera()` emits a `Camera` in the OpenCV convention (viewmat looks down +z).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gaussian_splat_tpu_torch._device import DeviceLike
from gaussian_splat_tpu_torch.camera import Camera


def _quat_from_axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = axis / max(np.linalg.norm(axis), 1e-12)
    h = 0.5 * angle
    return np.concatenate([[np.cos(h)], np.sin(h) * axis])


def _quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    w, xyz = q[0], q[1:]
    t = 2.0 * np.cross(xyz, v)
    return v + w * t + np.cross(xyz, t)


def _quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, av = a[0], a[1:]
    bw, bv = b[0], b[1:]
    return np.concatenate(
        [[aw * bw - av @ bv], aw * bv + bw * av + np.cross(av, bv)]
    )


@dataclasses.dataclass
class TrackballCamera:
    """Mutable interactive camera state + event handlers."""

    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 2.0, 5.0])
    )  # startup pose
    target: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    up: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 1.0, 0.0])
    )
    rotate_speed: float = 1.0
    zoom_speed: float = 1.2
    pan_speed: float = 0.3
    fov_y_deg: float = 45.0
    min_distance: float = 0.1
    max_distance: float = 100.0
    flip_up: bool = False  # start with up=(0,−1,0), the 3DGS scene convention

    _dragging: int = -1  # -1 none, 0 rotate, 1 pan
    _last_xy: tuple = (0.0, 0.0)

    def __post_init__(self):
        if self.flip_up:
            self.up = -self.up

    # -- event handlers -------------------------------------------------------
    def handle_mouse_down(self, x: float, y: float, button: int = 0) -> None:
        # button 0 rotates; 1/2 pan
        self._dragging = 0 if button == 0 else 1
        self._last_xy = (x, y)

    def handle_mouse_up(self) -> None:
        self._dragging = -1

    def handle_mouse_move(self, x: float, y: float, viewport_h: int = 720) -> None:
        if self._dragging < 0:
            return
        dx = x - self._last_xy[0]
        dy = y - self._last_xy[1]
        self._last_xy = (x, y)
        if self._dragging == 0:
            self._rotate(dx, dy)
        else:
            self._pan(dx, dy, viewport_h)

    def handle_scroll(self, delta_y: float) -> None:
        # distance ·= 0.95^(dy·zoomSpeed), clamped
        offset = self.position - self.target
        dist = np.linalg.norm(offset) * (0.95 ** (delta_y * self.zoom_speed))
        dist = float(np.clip(dist, self.min_distance, self.max_distance))
        self.position = self.target + offset / max(np.linalg.norm(offset), 1e-12) * dist

    # -- internals -----------------------------------------------------------
    def _rotate(self, dx: float, dy: float) -> None:
        # horizontal about world-Y, vertical about camera-right, both applied to
        # the eye offset AND the up vector
        offset = self.position - self.target
        q_h = _quat_from_axis_angle(
            np.array([0.0, 1.0, 0.0]), -dx * 0.01 * self.rotate_speed
        )
        fwd = -offset / max(np.linalg.norm(offset), 1e-12)
        right = np.cross(fwd, self.up)
        right /= max(np.linalg.norm(right), 1e-12)
        q_v = _quat_from_axis_angle(right, -dy * 0.01 * self.rotate_speed)
        q = _quat_mul(q_h, q_v)
        self.position = self.target + _quat_rotate(q, offset)
        self.up = _quat_rotate(q, self.up)

    def _pan(self, dx: float, dy: float, viewport_h: int) -> None:
        # camera-plane offset scaled by distance/viewportHeight
        offset = self.position - self.target
        dist = np.linalg.norm(offset)
        fwd = -offset / max(dist, 1e-12)
        right = np.cross(fwd, self.up)
        right /= max(np.linalg.norm(right), 1e-12)
        true_up = np.cross(right, fwd)
        scale = self.pan_speed * dist / max(viewport_h, 1)
        delta = (-dx * scale) * right + (dy * scale) * true_up
        self.position = self.position + delta
        self.target = self.target + delta

    # -- output --------------------------------------------------------------
    @property
    def distance(self) -> float:
        return float(np.linalg.norm(self.position - self.target))

    def camera(self, width: int, height: int, device: DeviceLike = None) -> Camera:
        return Camera.from_lookat(
            tuple(self.position),
            tuple(self.target),
            tuple(self.up),
            self.fov_y_deg,
            width,
            height,
            device,
        )
