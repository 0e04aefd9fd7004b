"""Share of the traced window in which no kernel, copy or fill ran on the
card (profiler), in %."""

from splatbench.metrics._read import idle

UNIT, LAYER, MOVES, SOURCE = "%", "device", "step_ms", "device_trace"


def read(r):
    return idle(r)
