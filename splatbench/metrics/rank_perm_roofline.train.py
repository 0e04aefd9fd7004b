"""rank_perm's roofline bound (splatbench/costs.py on the reference's counts)
over its device time by name from the profiler, in %."""

from splatbench.metrics._read import roofline

UNIT, LAYER, MOVES, SOURCE = "%", "rank order and segment sum", "step_ms", "device_trace"


def read(r):
    return roofline(r, "rank_perm")
