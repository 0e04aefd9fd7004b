"""Render and training configuration: the port's own copy of
gaussian_splat_tpu/config.py.

Every semantic field and default of the JAX `RenderConfig` is kept (the parity
tests compare them one by one). Dropped: the TPU-only knobs
`tiles_per_program`, `dma_chunks`, `exact_vjp` and the 128-lane rule on
`chunk_size`. `chunk_size` itself stays because `pair_budget` rounds to it, so
budgets — and therefore overflow truncation — equal the reference's.
`TrainConfig` has the reference's fields and defaults. The four sharding
fields are the reference's, read by parallel/sharded_render.py.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

BACKENDS = ("auto", "cuda", "torch_tile", "reference")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static rasterization configuration (frozen, hashable).

    Numeric-semantics constants are shared verbatim between the dense oracle,
    the torch tile compositor and the CUDA kernel so they agree to
    floating-point tolerance."""

    # Tiling -----------------------------------------------------------------
    tile_width: int = 32  # pixels per tile in x
    tile_height: int = 16  # pixels per tile in y (32×16 = 512 threads a block:
    #   16 warps of 8×4 pixels each when the width divides by 8 and the height
    #   by 4, else 32 row-major pixels a warp; csrc/raster_common.cuh)
    chunk_size: int = 128  # rounding unit of the pair budget (kept so budgets
    #   equal the reference's; the CUDA kernel has no alignment rule)

    # Binning capacities -----------------------------------------------------
    max_tiles_per_gaussian: int = 32  # cap on tile-rect area for the BIG tier;
    #   rects are shrunk to fit, counted in clamped_rects
    small_tiles_per_gaussian: int = 6  # tile-rect cap for the small tier
    big_gaussian_fraction: int = 32  # N/fraction big-tier slots by default
    big_tier_capacity: Optional[int] = None  # absolute override of the big
    #   tier's capacity (slots); `tier_overflow` is the runtime sentinel
    pairs_per_gaussian: float = 4.0  # pair budget = ceil(N * pairs_per_gaussian);
    #   overflow beyond it drops whole farthest gaussians and is reported in
    #   BinningResult.overflow

    # Projection -------------------------------------------------------------
    near_plane: float = 0.01
    cov2d_dilation: float = 0.3  # low-pass diagonal lift on the 2D covariance
    sigma_extent: float = 3.0  # billboard extent in σ; contributions beyond it
    #   (σ > sigma_cutoff) are zeroed in EVERY backend
    opacity_aware_extent: bool = True  # shrink extents to where α < alpha_skip
    antialiased: bool = False  # scale opacity by √(det Σ / det(Σ+dilation·I))

    # Compositing ------------------------------------------------------------
    alpha_clamp: float = 0.999  # max per-splat alpha
    alpha_skip: float = 1.0 / 255.0  # contributions below this are dropped
    transmittance_eps: float = 1e-6  # early-exit threshold of the CUDA kernel;
    #   semantics are defined with NO early-out, this only gates a skip whose
    #   error is ≤ this value
    sat_check: bool = True  # let a tile's block stop once every pixel has
    #   T < transmittance_eps. False = exact semantics, whole segment walked.

    # SH ---------------------------------------------------------------------
    sh_degree: int = 3

    # Background -------------------------------------------------------------
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    # Backend ----------------------------------------------------------------
    backend: str = "auto"  # "auto": CUDA tensors → "cuda" (the kernel), CPU
    #   tensors → "torch_tile". "cuda" on CPU tensors raises; nothing falls
    #   back from the kernel to the plain compositor.

    # Sharding (parallel/sharded_render.py) -----------------------------------
    shard_exchange: str = "all_gather"  # how projected features reach the
    #   tile-owning devices: "all_gather" (dense, 13 floats/splat — best ≤8
    #   devices, and each device then bins only the splats intersecting its
    #   band) or "all_to_all" (the sparse exchange: each device sends only the
    #   splats whose rect hits the destination band — traffic and per-device
    #   memory stay O(N/D) as the mesh grows)
    shard_capacity_margin: float = 0.25  # all_gather path: each device bins at
    #   most N/D + margin·N splats (the in-band compaction cap). The additive
    #   form matches the structure of band incidence: N/D residents plus an
    #   absolute tail of large splats whose extents cross band boundaries (the
    #   tail barely shrinks with D). A multiplicative cap N·f/D degenerates to
    #   "no compaction" at D=2, or drops splats at D≥4 when f is smaller; the
    #   margin form keeps compaction effective at every D. Drops are counted
    #   in stats.dropped_gaussians — calibrate_render_config(mesh_ndev=...)
    #   sizes the margin per scene.
    a2a_capacity_factor: float = 4.0  # all_to_all path: per (source, dest)
    #   send-buffer capacity = N/D² · factor; overflow is counted per source
    shard_capacity_floor: int = 4096  # minimum capacity regardless of factor:
    #   small scenes (where band-splat incidence ≫ N/D, e.g. single-tile-row
    #   bands) stay exact at negligible cost; at production N the factor term
    #   dominates. Tests lower this to exercise the overflow accounting.

    @property
    def sigma_cutoff(self) -> float:
        """Falloff-argument cutoff: σ > 0.5·extent² ⇒ no contribution."""
        return 0.5 * self.sigma_extent**2

    @property
    def tile_pixels(self) -> int:
        return self.tile_width * self.tile_height

    def tiles_x(self, width: int) -> int:
        return -(-width // self.tile_width)

    def tiles_y(self, height: int) -> int:
        return -(-height // self.tile_height)

    def num_tiles(self, width: int, height: int) -> int:
        return self.tiles_x(width) * self.tiles_y(height)

    def big_capacity(self, n_eff: int) -> int:
        """Big-tier slot count for an n_eff-row binning pass (floor of 64;
        `big_tier_capacity` overrides the fraction heuristic absolutely)."""
        if self.big_tier_capacity is not None:
            return min(n_eff, max(self.big_tier_capacity, 1))
        return min(n_eff, max(n_eff // self.big_gaussian_fraction + 1, 64))

    def pair_budget(self, n_gaussians: int) -> int:
        """Pair-list capacity, rounded up to a chunk multiple: the exact worst
        case for small scenes, the amortized `pairs_per_gaussian` budget (with
        a floor) for large ones."""
        m_big = self.big_capacity(n_gaussians)
        worst = (
            n_gaussians * self.small_tiles_per_gaussian
            + m_big * self.max_tiles_per_gaussian
        )
        budget = min(worst, max(int(n_gaussians * self.pairs_per_gaussian), 4096))
        c = self.chunk_size
        return -(-budget // c) * c


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop configuration."""

    lr_means: float = 1.6e-4
    lr_means_final: float = 1.6e-6  # 3DGS position-lr exponential decay target
    lr_decay_steps: Optional[int] = None  # decay horizon (defaults to the 3DGS
    #   30 000-iteration convention, independent of num_steps)
    lr_quats: float = 1e-3
    lr_scales: float = 5e-3
    lr_opacities: float = 5e-2
    lr_sh: float = 2.5e-3
    sh_warmup_every: int = 0  # 3DGS SH warmup: raise the active SH degree by 1
    #   every K steps (coefficients of inactive bands are masked inside the
    #   step; the model is untouched). 0 = off.
    ssim_weight: float = 0.2  # loss = (1-w)*L1 + w*(1-SSIM), 3DGS convention
    num_steps: int = 1000
    steps_per_dispatch: int = 1  # train steps per call of a step function (a
    #   Python loop here; the call returns the last step's loss)
    checkpoint_every: int = 500
    checkpoint_dir: Optional[str] = None
