"""Arithmetic the per-layer readers share."""

from splatbench import costs


def roofline(r: dict, kernel: str):
    """A kernel's bound over its device time, in %, for the traced calls
    whose reference counts the run has; None where nothing was read."""
    ms = r.get("kernel_ms", {}).get(kernel)
    bound = r.get("bound_ms", {}).get(kernel)
    if not ms or not ms[0] or bound is None:
        return None
    return 100.0 * bound / ms[0]


def idle(r: dict):
    if not r.get("trace_window_s"):
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["trace_window_s"])


def mfu(flops, ms):
    if not flops or not ms:
        return None
    return 100.0 * flops / (ms / 1e3 * costs.PEAK_FP32_FLOPS)
