"""Roofline bounds of the port's CUDA kernels on one NVIDIA H100.

Counterpart of gaussian_splat_tpu/utils/roofline.py, whose v5e peaks and
Mosaic pass counts do not apply to the port. The bound of a kernel's call is
the least time the card could take for the same work: the larger of

  * the bytes the function must move — each input read once, each output
    written once — over the HBM rate, and
  * the float32 operations it does on these inputs over the card's peak
    float32 rate outside the tensor cores (the kernels use no tensor core).

Where the work depends on the data (the raster kernels' early exit and keep
test), the counts are those of the call's own data: `steps` are the
(pixel, pair) steps inside the image over the pairs each tile walked before
it left its loop, `kept_steps` those that pass the keep test (chip_smoke.py
counts both in plain torch and holds the kernels' own counts to them).
"""

from __future__ import annotations

import dataclasses

# Published peaks of one H100 SXM (NVIDIA data sheet, at its 700 W limit):
# float32 outside the tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# NVLink from one H100 SXM to the other cards of its host, each way (the
# Hopper data sheet's 900 GB/s counts both ways).
NVLINK_BYTES_PER_S = 450e9

# Operations of one (pixel, splat) step of raster_fwd. Every step: 2
# subtractions and 7 for the quadratic form (the 2 halvings are per splat and
# not counted). Only a step that passes the keep test goes on: 1 exp, 1
# multiply, 1 min, 1 multiply for the weight, 8 in four multiply-adds, 2 for
# the transmittance update.
FLOPS_PER_STEP = 9
FLOPS_PER_KEPT_STEP = 14
# raster_bwd walks the same steps. A kept step costs the forward's 14, then
# 12 for gC·(C_total − C_upto) + tail, 7 for v, 4 for dα, 2 for dσ, 5 for the
# moments, 4 for the channel sums, and 10 additions into the block's sums.
FLOPS_PER_KEPT_STEP_BWD = 58

TABLE_COLS = 12  # floats per row of the splat table and of a gradient row
F32 = 4
I32 = 4


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """What one call must move and compute."""

    bytes: int
    flops: int

    @property
    def bytes_ms(self) -> float:
        return self.bytes / PEAK_BYTES_PER_S * 1e3

    @property
    def ops_ms(self) -> float:
        return self.flops / PEAK_FP32_FLOPS * 1e3

    def attainable_ms(self) -> float:
        """The bound: the larger of the two times."""
        return max(self.bytes_ms, self.ops_ms)

    def limiter(self) -> str:
        """"bytes" or "operations": which of the two sets the bound."""
        return "bytes" if self.bytes_ms > self.ops_ms else "operations"

    def fields(self) -> dict:
        """The bound as chip_smoke.py prints it beside a kernel's time."""
        return {
            "bound_ms": self.attainable_ms(), "bytes_ms": self.bytes_ms,
            "ops_ms": self.ops_ms, "bound_by": self.limiter(),
            "bytes": self.bytes, "flops": self.flops,
        }


def forward_cost(n_splats: int, pairs: int, num_tiles: int, width: int,
                 height: int, steps: int, kept_steps: int) -> KernelCost:
    """raster_fwd: reads the (N, 12) table, the pairs' ranks and two ints a
    tile; writes rgb, depth and T (5 floats) a pixel."""
    return KernelCost(
        bytes=n_splats * TABLE_COLS * F32 + pairs * I32 + 2 * num_tiles * I32
        + height * width * 5 * F32,
        flops=steps * FLOPS_PER_STEP + kept_steps * FLOPS_PER_KEPT_STEP,
    )


def backward_cost(n_splats: int, pairs: int, num_tiles: int, width: int,
                  height: int, num_rows: int, steps: int, kept_steps: int) -> KernelCost:
    """raster_bwd: reads the table, the pairs' ranks, three ints a tile (with
    `walked`), the forward's 5 floats and the 5 cotangent floats a pixel;
    writes one 12-float row per pair slot (`num_rows`, padding included)."""
    return KernelCost(
        bytes=n_splats * TABLE_COLS * F32 + pairs * I32 + 3 * num_tiles * I32
        + height * width * 10 * F32 + num_rows * TABLE_COLS * F32,
        flops=steps * FLOPS_PER_STEP + kept_steps * FLOPS_PER_KEPT_STEP_BWD,
    )


def segsum_cost(n_splats: int, pairs: int) -> KernelCost:
    """segsum: reads the real pairs' rows and int32 permutation entries and
    `rank_starts`, writes the (N, 12) table gradient; one addition per value
    read."""
    return KernelCost(
        bytes=pairs * (TABLE_COLS * F32 + I32) + (n_splats + 1) * I32
        + n_splats * TABLE_COLS * F32,
        flops=pairs * TABLE_COLS,
    )


def rank_perm_cost(n_splats: int, pairs: int, num_rows: int, slots: int,
                   big_rows: int) -> KernelCost:
    """rank_perm: reads the real pairs' emission slots, binning's kept cells
    (a byte a slot) and the big rows' ranks, and `rank_starts`; writes the
    (num_rows,) int32 permutation (padding rows included); a handful of
    integer operations a pair, counted as none beside the bytes."""
    return KernelCost(
        bytes=pairs * I32 + slots + big_rows * I32 + (n_splats + 1) * I32 + num_rows * I32,
        flops=0,
    )


def nvlink_ms(bytes_received: int) -> float:
    """The least time one card takes to receive `bytes_received` from the
    other cards of its host: the bound of a collective's exchange."""
    return bytes_received / NVLINK_BYTES_PER_S * 1e3
