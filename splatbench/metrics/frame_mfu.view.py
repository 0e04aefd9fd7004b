"""The float32 operations a served frame needs (splatbench/costs.py on the
reference's counts of the sampled poses) over the window's mean frame time
times the card's 67 TFLOP/s peak, in %."""

from splatbench.metrics._read import mfu

UNIT, LAYER, MOVES, SOURCE = "%", "whole frame", "frames_per_s", "host_clock"


def read(r):
    return mfu(r.get("flops_per_frame"), r.get("frame_ms_mean"))
