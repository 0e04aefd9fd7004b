"""Rank 0's device time a step of the work launched inside the program's
`sharded.exchange`, `sharded.exchange_bwd` and `sharded.frame_gather` ranges
(the records' all_gather, its reduce-scatter, the frame's and the stats'
gathers), over the traced steps after the window (profiler). A collective's
kernel runs until the slowest rank joins it: waiting is included."""

UNIT, LAYER, MOVES, SOURCE = "ms", "sharded render", "step_ms", "device_trace"


def read(r):
    return r.get("exchange_ms") or None
