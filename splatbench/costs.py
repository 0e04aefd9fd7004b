"""The yardstick's operation and byte counts, and the H100's peaks.

The kernel costs (`KernelCost` without its printing helpers, `forward_cost`,
`backward_cost`, `segsum_cost`, `rank_perm_cost`, the peaks, the per-step
operation counts) are a frozen copy of
gaussian_splat_tpu_torch/utils/roofline.py at commit
3d5d41b355dad50ee66f3d748f5ca0dbbef08fcd; this file does not import it, and
a change there does not change the benchmark. The counts fed to them come
from the benchmark's reference (splatbench/reference/render.py: pairs with a
kept pixel, steps before each tile saturates), never from the program.

Added here: the float32 operations of the stages the program does in plain
torch (projection, view directions, SH of degree 3, the loss, Adam), counted
by hand from the operations each stage's definition needs, one per add,
multiply, divide, compare-select, square root, exp or log, and the whole
step's and frame's totals built from them.
"""

from __future__ import annotations

import dataclasses

# Published peaks of one H100 SXM (NVIDIA data sheet, at its 700 W limit):
# float32 outside the tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# raster_fwd: 9 operations every (pixel, splat) step (2 subtractions, 7 for
# the quadratic form); a kept step adds 14 (exp, the α product and clamp,
# the weight, four multiply-adds, the transmittance update).
FLOPS_PER_STEP = 9
FLOPS_PER_KEPT_STEP = 14
# raster_bwd: the forward's 14, then 12 + 7 + 4 + 2 + 5 + 4 + 10 for the
# colour tail, v, dα, dσ, the moments, the channel sums and the block sums.
FLOPS_PER_KEPT_STEP_BWD = 58

TABLE_COLS = 12  # floats per row of the splat table and of a gradient row
F32 = 4
I32 = 4

# Plain-torch stages, operations per splat (forward):
#   projection 277: view transform 18, unit quaternion 13, rotation 39,
#   W·R 45, squared scales 3, Σview 48, clamped Jacobian 18, 2D covariance
#   27, determinant / dilation / conic / compensation 19, eigenvalue 7,
#   opacity-aware extent and radius 18, projected mean 6, cull 16;
#   view directions 13; activations (exp of 3 scales, sigmoid) 7;
#   SH of degree 3: 50 for the 16 basis functions, 2 × 16 × 3 for the
#   coefficient sums, 6 for the offset and clamp.
PROJECTION_FLOPS = 277
VIEW_DIR_FLOPS = 13
ACTIVATION_FLOPS = 7
SH_BASIS_FLOPS = 50
SH_COEFF_FLOPS = 2 * 3  # a coefficient: a multiply and an add, 3 channels
SH_TAIL_FLOPS = 6
# autograd through the above: two operations per forward operation
BACKWARD_FACTOR = 2
# loss, per pixel and channel: L1 3; SSIM: 3 products, 5 maps × 2 passes ×
# 11 taps × 2, 18 for the index and its mean; backward twice that
LOSS_FLOPS = 3 + 3 + 220 + 18
# Adam, per parameter: first moment 3, second 4, bias-corrected denominator
# 3, update 2
ADAM_FLOPS = 12
# what a viewer adds per pixel: background composite 3 × 3, to uint8 3 × 3
VIEW_PIXEL_FLOPS = 18


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
    """raster_bwd: reads the table, the pairs' ranks, three ints a tile,
    the forward's 5 floats and the 5 cotangent floats a pixel; writes one
    12-float row per pair slot (`num_rows`)."""
    return KernelCost(
        bytes=n_splats * TABLE_COLS * F32 + pairs * I32 + 3 * num_tiles * I32
        + height * width * 10 * F32 + num_rows * TABLE_COLS * F32,
        flops=steps * FLOPS_PER_STEP + kept_steps * FLOPS_PER_KEPT_STEP_BWD,
    )


def segsum_cost(n_splats: int, pairs: int) -> KernelCost:
    """segsum: reads the pairs' rows and int32 permutation entries and
    `rank_starts`, writes the (N, 12) table gradient; one addition per value
    read."""
    return KernelCost(
        bytes=pairs * (TABLE_COLS * F32 + I32) + (n_splats + 1) * I32
        + n_splats * TABLE_COLS * F32,
        flops=pairs * TABLE_COLS,
    )


def rank_perm_cost(n_splats: int, pairs: int, num_rows: int, slots: int,
                   big_rows: int) -> KernelCost:
    """rank_perm: reads the pairs' emission slots, the kept cells (a byte a
    slot) and the big rows' ranks, and `rank_starts`; writes the int32
    permutation; its integer operations count as none."""
    return KernelCost(
        bytes=pairs * I32 + slots + big_rows * I32 + (n_splats + 1) * I32 + num_rows * I32,
        flops=0,
    )


# -- the benchmark's use of the above ----------------------------------------


def tiles(width: int, height: int, tile_w: int = 32, tile_h: int = 16) -> int:
    return -(-width // tile_w) * -(-height // tile_h)


def sh_flops(degree: int) -> int:
    k = (degree + 1) ** 2
    basis = SH_BASIS_FLOPS if degree == 3 else {0: 0, 1: 3, 2: 20}[degree]
    return basis + k * SH_COEFF_FLOPS + SH_TAIL_FLOPS


def splat_forward_flops(n: int, sh_degree: int) -> int:
    """Projection, view directions, activations and SH of all N splats."""
    return n * (PROJECTION_FLOPS + VIEW_DIR_FLOPS + ACTIVATION_FLOPS + sh_flops(sh_degree))


def params_per_splat(sh_degree: int) -> int:
    return 3 + 4 + 3 + 1 + 3 * (sh_degree + 1) ** 2


def kernel_costs(c: dict, n: int, width: int, height: int) -> dict:
    """The four kernels' costs for one frame's reference counts `c`
    (pairs, kept_steps, cells, big_rows), counted as what these inputs need:
    a (pixel, pair) step is needed where it passes the keep test before its
    tile saturates (so `steps` = `kept_steps`: a step the keep test rejects
    changes nothing, and a kernel may cull it unseen); rows written and the
    permutation are one per needed pair; the kept cells one byte per
    candidate cell of the splats' boxes."""
    nt = tiles(width, height)
    kept = c["kept_steps"]
    return {
        "raster_fwd": forward_cost(n, c["pairs"], nt, width, height, kept, kept),
        "raster_bwd": backward_cost(n, c["pairs"], nt, width, height, c["pairs"], kept, kept),
        "segsum": segsum_cost(n, c["pairs"]),
        "rank_perm": rank_perm_cost(n, c["pairs"], c["pairs"], c.get("cells", 0),
                                    c.get("big_rows", 0)),
    }


def frame_flops(c: dict, n: int, sh_degree: int, width: int, height: int) -> int:
    """A served frame: the splats' forward, raster_fwd, the viewer's pixels."""
    k = kernel_costs(c, n, width, height)
    return (splat_forward_flops(n, sh_degree) + k["raster_fwd"].flops
            + width * height * VIEW_PIXEL_FLOPS)


def step_flops(c: dict, n: int, sh_degree: int, width: int, height: int) -> int:
    """A train step: the splats' forward and its autograd, raster_fwd,
    raster_bwd, segsum, the loss forward and backward, Adam."""
    k = kernel_costs(c, n, width, height)
    fwd = splat_forward_flops(n, sh_degree)
    return (fwd * (1 + BACKWARD_FACTOR) + k["raster_fwd"].flops + k["raster_bwd"].flops
            + k["segsum"].flops + width * height * 3 * LOSS_FLOPS * (1 + BACKWARD_FACTOR)
            + n * params_per_splat(sh_degree) * ADAM_FLOPS)
