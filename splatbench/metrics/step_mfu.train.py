"""The float32 operations a train step needs (splatbench/costs.py on the
reference's counts of the checked steps) over step_ms of the window times
the card's 67 TFLOP/s peak, in %."""

from splatbench.metrics._read import mfu

UNIT, LAYER, MOVES, SOURCE = "%", "whole step", "step_ms", "host_clock"


def read(r):
    return mfu(r.get("flops_per_step"), r.get("step_ms"))
