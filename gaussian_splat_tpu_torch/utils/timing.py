"""Per-stage timing + rolling metrics.

Counterpart of gaussian_splat_tpu/utils/timing.py. `ScopeTimer` scopes are
wall-clock with a device synchronisation at exit when they time a CUDA device
(PyTorch returns before the device finishes, so an unsynchronised scope would
measure the enqueue). `trace` is a `torch.profiler` scope that writes a
Chrome trace (the counterpart of `jax.profiler.trace`), `time_fn` the median
milliseconds of a call.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, Optional

import torch


class RollingStats:
    """Fixed-window rolling statistics."""

    def __init__(self, window: int = 120):
        self.window = window
        self._values: collections.deque = collections.deque(maxlen=window)

    def push(self, value: float) -> None:
        self._values.append(float(value))

    @property
    def mean(self) -> float:
        return sum(self._values) / len(self._values) if self._values else 0.0

    @property
    def last(self) -> float:
        return self._values[-1] if self._values else 0.0

    @property
    def min(self) -> float:
        return min(self._values) if self._values else 0.0

    @property
    def max(self) -> float:
        return max(self._values) if self._values else 0.0

    @property
    def median(self) -> float:
        vals = sorted(self._values)
        return vals[len(vals) // 2] if vals else 0.0

    def __len__(self) -> int:
        return len(self._values)


class ScopeTimer:
    """Named wall-clock scopes with device synchronization.

    Usage:
        timers = ScopeTimer(device)
        with timers.scope("frame"):
            out = render(...)
    """

    def __init__(self, device: Optional[torch.device] = None, window: int = 120):
        self.stats: Dict[str, RollingStats] = {}
        self.window = window
        self.device = None if device is None else torch.device(device)

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def scope(self, name: str):
        self._sync()  # work queued before the scope is not its own
        start = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            elapsed_ms = (time.perf_counter() - start) * 1000.0
            self.stats.setdefault(name, RollingStats(self.window)).push(elapsed_ms)

    def summary(self) -> Dict[str, float]:
        return {name: s.mean for name, s in self.stats.items()}

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.stats.items()):
            lines.append(
                f"{name:<24} last {s.last:8.3f} ms   mean {s.mean:8.3f} ms   "
                f"min {s.min:8.3f}   max {s.max:8.3f}   (n={len(s)})"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profiler scope: host and (where there is one) CUDA activity, written
    to `log_dir` as a Chrome trace (`*.pt.trace.json`) when the scope ends.
    Yields the `torch.profiler.profile` (its `key_averages()`, `events()`),
    or None and does nothing when `log_dir` is None."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn, *args, warmup: int = 2, iters: int = 10, **kwargs) -> float:
    """Benchmark helper: median wall-clock ms of `fn(*args)`, the device
    synchronised before and after each call."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    times = []
    for _ in range(iters):
        _sync()
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync()
        times.append((time.perf_counter() - t0) * 1000.0)
    times.sort()
    return times[len(times) // 2]
