"""The largest band's records kept after the band test, over N/D, mean over
the window's renders (the program's `parallel.sharded_render.counters`):
band imbalance plus the tail of splats that cross a band's edge, what the
sharded path's `max_active` cap has to cover."""

UNIT, LAYER, MOVES, SOURCE = "N/D", "sharded render", "step_ms", "program_counter"


def read(r):
    return r.get("max_records_share")
