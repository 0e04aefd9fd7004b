"""The benchmark's own inputs, made from `--seed`: splats, cameras, targets.

Everything here is plain torch and reads only a configuration file's
`scene`, `cameras` and `targets` groups. The program under test receives the
tensors made here; the reference (splatbench/reference/) receives the same
tensors. Nothing here imports the program.

Splats are made in blocks of `BLOCK_ROWS` rows, each block from its own
generator seeded by (seed, block): rows [a, b) of a scene are the same
whichever rows around them are made, so a block of rows can be made alone.
A row's region (its place in the scene) follows from its index and the
regions' shares alone, so every seed gives the same number of splats in each
region: the seed moves splats, not the amount of work.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

BLOCK_ROWS = 1 << 20
SH_C0 = 0.28209479177387814
LEAVES = ("means", "quats", "log_scales", "opacity_logits", "sh")


def sub_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for one stream of draws, from the run's seed (any whole
    number, larger than 32 bits too) and the stream's numbers."""
    state = np.random.SeedSequence([int(seed) & (2**64 - 1), *stream]).generate_state(2, np.uint32)
    return int(state[0]) | (int(state[1] & 0x7FFFFFFF) << 32)


def generator(seed: int, device, *stream: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, *stream))
    return gen


def region_bounds(regions: List[dict], n: int) -> List[int]:
    """Row boundaries of the regions: region k holds rows [b[k], b[k+1])."""
    shares = np.cumsum([r["share"] for r in regions])
    if abs(shares[-1] - 1.0) > 1e-9:
        raise ValueError(f"region shares sum to {shares[-1]}, not 1")
    return [0, *[int(round(s * n)) for s in shares[:-1]], n]


def relief(x: torch.Tensor, z: torch.Tensor, waves: List[List[float]]) -> torch.Tensor:
    """Height of a ground slab: a fixed sum of waves [amp, fx, fz, phase]."""
    y = torch.zeros_like(x)
    for amp, fx, fz, phase in waves:
        y = y + amp * torch.sin(fx * x + phase) * torch.cos(fz * z + 0.5 * phase)
    return y


def _positions(kind: str, p: dict, u: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(rows, 3) positions of one region from uniforms `u` and normals `g`."""
    c = torch.tensor(p.get("center", [0.0, 0.0, 0.0]), dtype=u.dtype, device=u.device)
    if kind == "box":
        half = torch.tensor(p["half"], dtype=u.dtype, device=u.device)
        return c + (2.0 * u - 1.0) * half
    if kind == "slab":
        hx, hz = p["half"]
        x = (2.0 * u[:, 0] - 1.0) * hx
        z = (2.0 * u[:, 2] - 1.0) * hz
        y = relief(x, z, p.get("relief", [])) + p["thickness"] * g[:, 1]
        return c + torch.stack([x, y, z], dim=-1)
    if kind == "shell":
        r0, r1 = p["radius"]
        # directions uniform over the upper half of the sphere
        d = g / torch.linalg.norm(g, dim=-1, keepdim=True).clamp_min(1e-12)
        d = torch.stack([d[:, 0], d[:, 1].abs(), d[:, 2]], dim=-1)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp_min(1e-12)
        r = r0 + (r1 - r0) * u[:, 0]
        return c + d * r[:, None]
    raise ValueError(f"unknown region kind {kind!r}")


def _block(scene: dict, n: int, sh_degree: int, lo: int, hi: int, seed: int, device):
    """Rows [lo, hi) of the scene's five leaves."""
    gen = generator(seed, device, 1, lo // BLOCK_ROWS)
    rows = hi - lo
    k = (sh_degree + 1) ** 2

    def uni(*shape):
        return torch.rand(shape, generator=gen, device=device)

    def nrm(*shape):
        return torch.randn(shape, generator=gen, device=device)

    # a fixed order of draws, whatever the regions
    u_pos, g_pos, g_scale, g_quat = uni(rows, 3), nrm(rows, 3), nrm(rows, 3), nrm(rows, 4)
    g_op, g_sh = nrm(rows), nrm(rows, k, 3)

    means = torch.empty((rows, 3), device=device)
    log_scales = torch.empty((rows, 3), device=device)
    opacity_logits = torch.empty((rows,), device=device)
    sh = torch.empty((rows, k, 3), device=device)
    bounds = region_bounds(scene["regions"], n)
    for reg, a, b in zip(scene["regions"], bounds[:-1], bounds[1:]):
        a, b = max(a, lo) - lo, min(b, hi) - lo
        if a >= b:
            continue
        s = slice(a, b)
        means[s] = _positions(reg["kind"], reg, u_pos[s], g_pos[s])
        ls = reg["log_scale"]
        scale = ls["mean"] + ls["std"] * g_scale[s]
        log_scales[s] = scale.clamp(ls["min"], ls["max"])
        op = reg["opacity_logit"]
        opacity_logits[s] = op["mean"] + op["std"] * g_op[s]
        col = reg["sh"]
        sh[s, 0] = col["dc_mean"] + col["dc_std"] * g_sh[s, 0]
        sh[s, 1:] = col["rest_std"] * g_sh[s, 1:]
    quats = g_quat / torch.linalg.norm(g_quat, dim=-1, keepdim=True).clamp_min(1e-12)
    return means, quats, log_scales, opacity_logits, sh


def make_splats(cfg: dict, seed: int, device, rows=None) -> Dict[str, torch.Tensor]:
    """The scene's five leaves (float32, on `device`): rows [a, b) of the
    whole scene when `rows` = (a, b), else all N rows."""
    n = cfg["N"]
    lo, hi = rows if rows is not None else (0, n)
    parts = []
    first = lo - lo % BLOCK_ROWS
    for start in range(first, hi, BLOCK_ROWS):
        a, b = max(start, lo), min(start + BLOCK_ROWS, hi)
        block = _block(cfg["scene"], n, cfg["sh_degree"], start, min(start + BLOCK_ROWS, n),
                       seed, device)
        parts.append([leaf[a - start:b - start] for leaf in block])
    if len(parts) == 1:
        return {name: leaf.contiguous() for name, leaf in zip(LEAVES, parts[0])}
    return {name: torch.cat([p[i] for p in parts]) for i, name in enumerate(LEAVES)}


class CameraParams(NamedTuple):
    """A pinhole camera as the benchmark makes it: world→camera (OpenCV
    axes: +x right, +y down, +z forward), intrinsics in pixels."""

    viewmat: torch.Tensor  # (4, 4) float32, on the host
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> torch.Tensor:
    eye, target, up = (torch.tensor(v, dtype=torch.float64) for v in (eye, target, up))
    fwd = target - eye
    fwd = fwd / torch.linalg.norm(fwd)
    right = torch.linalg.cross(fwd, up)
    right = right / torch.linalg.norm(right)
    down = torch.linalg.cross(fwd, right)
    rot = torch.stack([right, down, fwd])
    view = torch.eye(4, dtype=torch.float64)
    view[:3, :3] = rot
    view[:3, 3] = -rot @ eye
    return view.to(torch.float32)


def ring(spec: dict, width: int, height: int) -> List[CameraParams]:
    """`count` cameras on a circle of `radius` at `height` above `target`,
    looking at it, one full turn from `start_deg`."""
    f = 0.5 * height / math.tan(math.radians(spec["fov_y_deg"]) / 2.0)
    tx, ty, tz = spec["target"]
    cams = []
    for i in range(spec["count"]):
        az = math.radians(spec.get("start_deg", 0.0) + 360.0 * i / spec["count"])
        eye = (tx + spec["radius"] * math.sin(az), ty + spec["height"],
               tz + spec["radius"] * math.cos(az))
        cams.append(CameraParams(look_at(eye, spec["target"]), f, f, width / 2.0,
                                 height / 2.0, width, height))
    return cams


def cameras(cfg: dict, which: str) -> List[CameraParams]:
    """The configuration's camera set `which` ("train" or "orbit")."""
    return ring(cfg["cameras"][which], cfg["width"], cfg["height"])


def make_targets(cfg: dict, seed: int, device, views: int) -> torch.Tensor:
    """(views, H, W, 3) float32 training images in [0, 1], plain torch from
    the seed: smooth colour fields (uniform on a coarse grid, bilinear up)
    plus fine noise. Never rendered by the program."""
    t = cfg["targets"]
    h, w = cfg["height"], cfg["width"]
    gen = generator(seed, device, 2)
    coarse = torch.rand((views, 3, -(-h // t["cell"]), -(-w // t["cell"])),
                        generator=gen, device=device)
    img = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear",
                                          align_corners=False)
    img = img + t["noise"] * torch.randn((views, 3, h, w), generator=gen, device=device)
    return img.clamp_(0.0, 1.0).permute(0, 2, 3, 1).contiguous()


def view_sequence(seed: int, views: int, count: int) -> np.ndarray:
    """The order in which a training run visits its views: uniform draws."""
    return np.random.default_rng(sub_seed(seed, 3)).integers(0, views, size=count)


def render_settings(cfg: dict, traffic: Optional[dict] = None) -> dict:
    """The rendering semantics the configuration and the traffic mix state
    (RenderConfig's semantic fields, defaults unless a file says otherwise),
    for the reference; the program receives the same values through
    RenderConfig."""
    out = dict(SEMANTIC_DEFAULTS)
    fields = {**cfg.get("render_config", {}), **(traffic or {}).get("render_config", {})}
    out.update({k: v for k, v in fields.items() if k in out})
    out["sh_degree"] = min(out["sh_degree"], cfg["sh_degree"])
    return out


# RenderConfig's semantic defaults, as the reference takes them
SEMANTIC_DEFAULTS = {
    "near_plane": 0.01,
    "cov2d_dilation": 0.3,
    "sigma_extent": 3.0,
    "opacity_aware_extent": True,
    "alpha_clamp": 0.999,
    "alpha_skip": 1.0 / 255.0,
    "sh_degree": 3,
    "background": (0.0, 0.0, 0.0),
}
