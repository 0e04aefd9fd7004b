"""Bytes a rank of the sharded train step must receive from the other ranks,
and the link's peak: the bound behind `exchange_roofline.train4`.

Counted from the scheme's definition (parallel/sharded_render.py's module
docstring), not from the program: each of D ranks holds N/D splats and owns a
band of the frame's 16-row tile rows split D ways. A step, per rank:

  * the records' all_gather: the other ranks' (D − 1)·N/D records of 13
    float32 (52 B) each;
  * its transpose, a reduce-scatter: the other ranks' partial gradients of
    this rank's N/D records, (D − 1)·N/D rows of 52 B (what a ring or a
    direct reduce-scatter moves into each rank);
  * the frame's gather: the other bands, D − 1 of band_rows × W pixels of 5
    float32 (colour, transmittance, depth);
  * the stats' gather: the other bands' 7 int32.

The link: NVLink 4 of an H100 SXM, 18 links of 25 GB/s each way, 450 GB/s
into one card (NVIDIA H100 data sheet).
"""

from __future__ import annotations

RECORD_BYTES = 13 * 4
FRAME_BYTES_PER_PIXEL = 5 * 4
STATS_BYTES = 7 * 4
TILE_ROWS = 16
NVLINK_BYTES_PER_S = 450e9


def step_bytes(n: int, ndev: int, width: int, height: int) -> int:
    """Bytes one rank receives in one train step's exchanges."""
    others = ndev - 1
    records = others * (n // ndev) * RECORD_BYTES
    tile_rows = -(-height // TILE_ROWS)
    band_rows = -(-tile_rows // ndev) * TILE_ROWS
    frame = others * band_rows * width * FRAME_BYTES_PER_PIXEL
    return 2 * records + frame + others * STATS_BYTES

