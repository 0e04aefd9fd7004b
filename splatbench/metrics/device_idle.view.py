"""Share of the traced window in which no kernel, copy or fill ran on the
card (profiler), in %."""

from splatbench.metrics._read import idle

UNIT, LAYER, MOVES, SOURCE = "%", "device", "frame_ms_p95", "device_trace"


def read(r):
    return idle(r)
