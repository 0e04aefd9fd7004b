"""The viewer's own work after the render: the benchmark's span around
`Viewer.render_frame` less the program's "frame" scope (its render), mean
over the window's frames: the background composite, to_uint8, the host copy."""

UNIT, LAYER, MOVES, SOURCE = "ms", "viewer", "frame_ms_p95", "program_span"


def read(r):
    return r.get("post_render_ms")
