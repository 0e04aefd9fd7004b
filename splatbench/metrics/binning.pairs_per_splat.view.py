"""The program's pairs a frame (`RenderOutput.stats.num_pairs`, before any
budget cut) over N, mean over the window's view calls."""

UNIT, LAYER, MOVES, SOURCE = "pairs/splat", "binning", "frame_ms_p95", "program_counter"


def read(r):
    return r.get("pairs_per_splat")
