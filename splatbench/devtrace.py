"""Reading a `torch.profiler` trace of the card: device busy time, kernel
time by name, device time under a host range, and where the device waits.

`device_busy` is a copy of chip_smoke.py's `device_busy` at commit
3d5d41b355dad50ee66f3d748f5ca0dbbef08fcd (the union of the device events'
intervals), extended to leave out user annotations, which the profiler also
places on the device timeline; this file does not import chip_smoke.py.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
from typing import Dict, List, Tuple

import torch


@contextlib.contextmanager
def traced(enabled: bool):
    """A profiler over host and card activity, or nothing."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof


def device_events(prof) -> list:
    """Kernels, copies and fills on the card (annotations left out)."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_busy(prof) -> Tuple[float, int]:
    """(busy ms, events): the union of the device events' intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in device_events(prof))
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3, len(spans)


def kernel_ms(prof, prefix: str) -> Tuple[float, int]:
    """(device ms, launches) of the kernels whose name starts with `prefix`
    (after the `void ` that a C++ kernel's name carries)."""
    hits = [e for e in device_events(prof) if e.name.removeprefix("void ").startswith(prefix)]
    return sum(e.time_range.elapsed_us() for e in hits) / 1e3, len(hits)


def range_device_ms(prof, name: str) -> Tuple[float, int]:
    """(device ms, ranges) of the work launched inside the host ranges
    called `name` (torch's own `Optimizer.step#Adam.step`, for one)."""
    hits = [e for e in prof.events()
            if e.name == name and e.device_type == torch.autograd.DeviceType.CPU]
    return sum(e.device_time_total for e in hits) / 1e3, len(hits)


def _short(name: str) -> str:
    """A kernel or op name without its argument list and namespaces."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")
    for ns in ("at::native::", "at_cuda_detail::", "at::", "std::"):
        name = name.replace(ns, "")
    return name[:96]


def breakdown(prof, top: int = 10) -> Dict[str, List[list]]:
    """The device operations that took most time, and the idle gaps of the
    card summed by the innermost host operation running at each gap's
    middle, in seconds, `top` of each."""
    dev = device_events(prof)
    by_op = collections.Counter()
    for e in dev:
        by_op[_short(e.name)] += e.time_range.elapsed_us() / 1e6
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    gaps, end = [], None
    for a, b in spans:
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CPU and not e.is_async)
    starts = [h[0] for h in host]
    by_host = collections.Counter()
    for a, b in gaps:
        mid = 0.5 * (a + b)
        # the innermost host op holding `mid` is the latest-starting one
        name = "(no host op)"
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if host[i][1] >= mid:
                name = _short(host[i][2])
                break
        by_host[name] += (b - a) / 1e6
    return {
        "device_ops": [[k, v] for k, v in by_op.most_common(top)],
        "idle_gaps": [[k, v] for k, v in by_host.most_common(top)],
    }
