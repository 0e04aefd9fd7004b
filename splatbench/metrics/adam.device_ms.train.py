"""Device time of the work launched under torch's `Optimizer.step#Adam.step`
range, a step, over the traced steps after the window (profiler)."""

UNIT, LAYER, MOVES, SOURCE = "ms", "trainer", "step_ms", "device_trace"


def read(r):
    return r.get("adam_ms") or None
