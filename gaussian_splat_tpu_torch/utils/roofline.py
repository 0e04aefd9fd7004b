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


def sh_forward_cost(n_splats: int, degree: int) -> KernelCost:
    """sh_fwd: reads the (degree+1)² coefficients a row that the degree uses
    (of the K it holds) and, above degree 0, the row's direction; writes 3
    floats a row. Operations: the multiply-add of each used coefficient and
    channel, counted as two; the basis is not counted."""
    used = (degree + 1) ** 2
    return KernelCost(
        bytes=n_splats * (3 * used * F32 + (3 * F32 if degree else 0) + 3 * F32),
        flops=n_splats * 2 * 3 * used,
    )


def sh_backward_cost(n_splats: int, coefficients: int, degree: int) -> KernelCost:
    """sh_bwd: reads what sh_fwd reads and the 3 cotangent floats a row;
    writes all `coefficients` × 3 floats of the coefficients' gradient (zeros
    past the used ones) and 3 of the direction's. Operations: the forward's
    sums again (the clamp's test), a multiply-add a used coefficient and
    channel for <sh_k, g> and one for the direction's gradient, and a
    multiply for the coefficient's gradient."""
    used = (degree + 1) ** 2
    return KernelCost(
        bytes=n_splats * (3 * used * F32 + (3 * F32 if degree else 0) + 3 * F32
                          + 3 * coefficients * F32 + 3 * F32),
        flops=n_splats * 3 * used * (2 + 2 + 2 + 1),
    )


# The projection's bytes a row. proj_fwd reads means (3 floats), quats (4),
# scales (3) and, where the extent is opacity-aware, the opacity (1); it
# writes means2d (2), conics (3), depth (1), radius (int32), valid (1 byte),
# cov2d (3), compensation (1), extents (2) and the direction (3). proj_bwd
# reads the inputs again and the cotangents it is given, and writes the
# gradients of means, quats, scales and (opacity-aware, with an extents
# cotangent) the opacity.
PROJ_INPUT_BYTES = (3 + 4 + 3) * F32
PROJ_OUTPUT_BYTES = (2 + 3 + 1 + 3 + 1 + 2 + 3) * F32 + I32 + 1
PROJ_COTANGENT_FLOATS = dict(means2d=2, conics=3, depths=1, cov2d=3, compensation=1,
                             extents=2, dirs=3)
PROJ_CAMERA_BYTES = (16 + 4 + 3) * F32  # viewmat, fx fy cx cy, the centre
# Operations a row, each multiply, add, divide, square root, logarithm,
# comparison, min and max counted as one: the forward's ~280 (view transform
# 18, rotation 51, Σview 96, Jacobian and clamp 23, 2D covariance 27, conic,
# compensation and eigenvalue 24, extents and radius 16, centre and culls
# 14, direction 13); the backward recomputes them and walks back ~420 more.
FLOPS_PER_ROW_PROJ_FWD = 280
FLOPS_PER_ROW_PROJ_BWD = 280 + 420


def projection_forward_cost(n_splats: int, opacity_aware: bool) -> KernelCost:
    """proj_fwd: the inputs read once, every output written once."""
    return KernelCost(
        bytes=n_splats * (PROJ_INPUT_BYTES + (F32 if opacity_aware else 0) + PROJ_OUTPUT_BYTES)
        + PROJ_CAMERA_BYTES,
        flops=n_splats * FLOPS_PER_ROW_PROJ_FWD,
    )


def projection_backward_cost(n_splats: int, opacity_aware: bool, cotangents) -> KernelCost:
    """proj_bwd under the cotangents named in `cotangents` (the others take
    no gradient): the inputs and those cotangents read once, the gradients
    that they reach written once."""
    reads = PROJ_INPUT_BYTES + (F32 if opacity_aware else 0) \
        + F32 * sum(PROJ_COTANGENT_FLOATS[k] for k in cotangents)
    geometry = any(k in cotangents for k in ("conics", "cov2d", "compensation", "extents"))
    writes = 3 * F32 + (7 * F32 if geometry else 0) \
        + (F32 if opacity_aware and "extents" in cotangents else 0)
    return KernelCost(
        bytes=n_splats * (reads + writes) + PROJ_CAMERA_BYTES,
        flops=n_splats * FLOPS_PER_ROW_PROJ_BWD,
    )


def nvlink_ms(bytes_received: int) -> float:
    """The least time one card takes to receive `bytes_received` from the
    other cards of its host: the bound of a collective's exchange."""
    return bytes_received / NVLINK_BYTES_PER_S * 1e3


def binning_cost(n_splats: int, active: int, num_tiles: int, budget: int, k_small: int,
                 k_big: int, big_rows: int, sigma_test: bool = True,
                 extents: bool = True) -> KernelCost:
    """binning's chain (bin_rects, bin_count, bin_offsets, bin_scatter; the
    depth argsort before it is not counted): reads each splat's inputs once
    — means2d, the extents (or the radii), valid, with the σ test the conics
    and the opacity — and its rank in `order` (int64); writes the kept cells
    (a byte a slot of the `active` small rows and the big rows), the big
    rows' ranks, rank_starts, each tile's offset and count, the sentinels,
    and the budget-length pair list (pair_gauss, pair_tile, pair_src). The
    σ test's ~40 operations a rect cell are counted as none beside the
    bytes, as rank_perm's integer work is."""
    per_splat = 2 * F32 + (2 * F32 if extents else I32) + 1 + (4 * F32 if sigma_test else 0) + 8
    return KernelCost(
        bytes=n_splats * per_splat + active * k_small + big_rows * (k_big + I32)
        + (active + 1) * I32 + 2 * num_tiles * I32 + 5 * I32 + budget * 3 * I32,
        flops=0,
    )
