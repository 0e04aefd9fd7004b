"""What the runners share: the run's context, the program's inputs made from
the benchmark's, sentinel and launch tallies, and the verdict on numbers
compared with their limits."""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from splatbench import scene

SENTINELS = ("overflow", "clamped_rects", "dropped_gaussians", "tier_overflow")


@dataclasses.dataclass
class Context:
    """One run of one cell."""

    cell: dict  # the BENCHMARK.json workload entry
    cfg: dict  # splatbench/configs/<config>.json
    traffic: dict  # splatbench/traffic/<traffic>.json
    limits: dict  # splatbench/limits/<cell>.json
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float  # the host clock when the process started
    fault: Optional[str] = None  # a planted fault (the harness's own tests)
    marks: List[tuple] = dataclasses.field(default_factory=list)  # set-up's parts

    def mark(self, part: str) -> None:
        """Set-up's part `part` has ended: the host clock since the start."""
        self.sync()
        self.marks.append((part, time.perf_counter() - self.t0))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class Outcome:
    """What a runner hands back to the harness."""

    e2e: Dict[str, float]  # end-to-end metrics by name
    readings: dict  # what the per-layer metrics read
    checks: Dict[str, dict]  # name -> {"value", "limit"}
    attempted: int
    failed: int
    memory_peak_bytes: int
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None
    setup_parts: Optional[list] = None  # (part, seconds since the start)

    @property
    def correct(self) -> bool:
        return all(c["value"] <= c["limit"] for c in self.checks.values())


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def program_camera(c: scene.CameraParams, device):
    """The program's Camera holding the benchmark's numbers."""
    from gaussian_splat_tpu_torch.camera import Camera

    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return Camera(viewmat=c.viewmat.to(device), fx=scalar(c.fx), fy=scalar(c.fy),
                  cx=scalar(c.cx), cy=scalar(c.cy), width=c.width, height=c.height)


def render_config(cfg: dict, traffic: dict):
    """The program's RenderConfig: the configuration's fields, then those
    the traffic mix sets for its loop (a capacity that training outgrows)."""
    from gaussian_splat_tpu_torch.config import RenderConfig

    fields = {**cfg.get("render_config", {}), **traffic.get("render_config", {})}
    return RenderConfig(sh_degree=cfg["sh_degree"], **fields)


def calibration(cfg: dict, traffic: dict) -> dict:
    """`calibrate_render_config`'s headrooms: the configuration's, then the
    traffic mix's (training grows splats past a headroom sized for a
    frame)."""
    return {**cfg.get("calibrate", {}), **traffic.get("calibrate", {})}


def build_kernels(device) -> None:
    """Build (or find built) the program's CUDA kernels: set-up's work."""
    if device.type == "cuda":
        from gaussian_splat_tpu_torch import _build

        _build.build_all()


def launches() -> Dict[str, int]:
    from gaussian_splat_tpu_torch.ops import cuda_raster

    return dict(cuda_raster.launch_counts)


def launch_gap(before: Dict[str, int], kernels, calls: int, device) -> int:
    """How far each kernel's launches since `before` are from one a call
    (0 on the CPU, where the program launches none)."""
    if device.type != "cuda":
        return 0
    now = launches()
    return max(abs(now[k] - before[k] - calls) for k in kernels)


def tally(stats: List, expected: int) -> Dict[str, float]:
    """Sums of the program's binning counters over calls (one read of the
    card), the mean pairs a call, and `missing`: how far the calls that left
    counters of their own (not None, and no other call's object) are from
    the `expected` calls the runner made. Counters that stop reaching the
    runner would otherwise sum to 0 and pass the sentinels unread."""
    own = list({id(s): s for s in stats if s is not None}.values())
    missing = abs(expected - len(own))
    if not own:
        return {"calls": 0, "missing": missing, "num_pairs_mean": 0.0,
                **dict.fromkeys(SENTINELS, 0)}
    cols = {name: torch.stack([getattr(s, name).reshape(()) for s in own]).to(torch.int64)
            for name in ("num_pairs", *SENTINELS)}
    out = {name: int(cols[name].sum()) for name in SENTINELS}
    out["num_pairs_mean"] = float(cols["num_pairs"].double().mean())
    out["calls"], out["missing"] = len(own), missing
    return out


def peak_reset(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def now() -> float:
    return time.perf_counter()


def free(device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def check(value: float, limit: float) -> dict:
    return {"value": float(value), "limit": float(limit)}
