"""Posed-image dataset ingestion: Blender/nerfstudio `transforms.json`.

Counterpart of gaussian_splat_tpu/io/dataset_io.py. Reads the de-facto
standard `transforms.json` layout (NeRF-synthetic / nerfstudio):

    {"camera_angle_x": ..., "frames": [{"file_path": ...,
      "transform_matrix": [[...4x4 camera-to-world, OpenGL axes...]]}]}

Conversions applied:
  * camera-to-world (OpenGL: +x right, +y up, −z forward) → the framework's
    world-to-camera OpenCV convention (+y down, +z forward): invert, then
    negate the y/z rows.
  * `camera_angle_x` (horizontal FOV) → fx = W/(2·tan(fov_x/2)); per-frame or
    global `fl_x/fl_y/cx/cy/w/h` keys (nerfstudio) are honored when present.

The matrices and intrinsics are computed in numpy, as the JAX package does,
and only then become tensors on the dataset's device.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from gaussian_splat_tpu_torch._device import DeviceLike, resolve_device
from gaussian_splat_tpu_torch.camera import Camera
from gaussian_splat_tpu_torch.train.dataset import ViewDataset

_GL_TO_CV = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)


def c2w_opengl_to_viewmat(c2w: np.ndarray) -> np.ndarray:
    """OpenGL camera-to-world → OpenCV world-to-camera (viewmat)."""
    c2w = np.asarray(c2w, np.float32).reshape(4, 4)
    w2c = np.linalg.inv(c2w)
    return _GL_TO_CV @ w2c


def load_transforms(
    path: str,
    downscale: int = 1,
    max_frames: Optional[int] = None,
    device: DeviceLike = None,
) -> ViewDataset:
    """Load a transforms.json dataset into a ViewDataset on `device` (None:
    the GPU). `path` may point at the json file or its directory."""
    from PIL import Image

    device = resolve_device(device)
    if os.path.isdir(path):
        path = os.path.join(path, "transforms.json")
    root = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        meta = json.load(f)

    frames = meta["frames"]
    if max_frames is not None:
        frames = frames[:max_frames]
    if not frames:
        raise ValueError(f"no frames in {path}")

    def scalar(v):
        return torch.tensor(np.float32(v), dtype=torch.float32, device=device)

    views = []
    for fr in frames:
        fp = fr["file_path"]
        img_path = os.path.join(root, fp)
        if not os.path.exists(img_path):
            for ext in (".png", ".jpg", ".jpeg"):
                if os.path.exists(img_path + ext):
                    img_path = img_path + ext
                    break
        img = Image.open(img_path).convert("RGB")
        if downscale > 1:
            img = img.resize(
                (img.width // downscale, img.height // downscale), Image.LANCZOS
            )
        w, h = img.width, img.height

        fx = fr.get("fl_x", meta.get("fl_x"))
        fy = fr.get("fl_y", meta.get("fl_y"))
        if fx is None:
            fov_x = fr.get("camera_angle_x", meta.get("camera_angle_x"))
            if fov_x is None:
                raise ValueError("transforms.json lacks fl_x and camera_angle_x")
            fx = (w * downscale) / (2.0 * np.tan(0.5 * float(fov_x)))
        fx = float(fx) / downscale
        fy = float(fy) / downscale if fy is not None else fx
        cx = float(fr.get("cx", meta.get("cx", w * downscale / 2.0))) / downscale
        cy = float(fr.get("cy", meta.get("cy", h * downscale / 2.0))) / downscale

        cam = Camera(
            viewmat=torch.from_numpy(
                c2w_opengl_to_viewmat(fr["transform_matrix"])
            ).to(device),
            fx=scalar(fx),
            fy=scalar(fy),
            cx=scalar(cx),
            cy=scalar(cy),
            width=w,
            height=h,
        )
        views.append((cam, np.asarray(img, np.float32) / 255.0))

    return ViewDataset.from_views(views, device=device)


def save_transforms(path: str, dataset: ViewDataset, image_dir: str = "images") -> None:
    """Write a ViewDataset back out as transforms.json + PNGs (round-trip and
    interchange with the wider NeRF/3DGS tooling)."""
    from PIL import Image

    os.makedirs(os.path.join(path, image_dir), exist_ok=True)
    viewmats = dataset.viewmats.detach().cpu().numpy()
    images = dataset.images.detach().cpu().numpy()
    frames = []
    for i in range(dataset.num_views):
        w2c_gl = _GL_TO_CV @ viewmats[i]  # invert the axis flip
        c2w = np.linalg.inv(w2c_gl)
        rel = f"{image_dir}/frame_{i:04d}.png"
        img = (np.clip(images[i], 0, 1) * 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(path, rel))
        frames.append(
            {"file_path": rel, "transform_matrix": c2w.tolist()}
        )
    meta = {
        "fl_x": float(dataset.fx),
        "fl_y": float(dataset.fy),
        "cx": float(dataset.cx),
        "cy": float(dataset.cy),
        "w": dataset.width,
        "h": dataset.height,
        "frames": frames,
    }
    with open(os.path.join(path, "transforms.json"), "w") as f:
        json.dump(meta, f, indent=1)
