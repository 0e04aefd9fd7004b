"""Sharded render pipeline: splat-parallel projection → feature exchange →
tile-parallel rasterization, one process per device.

Counterpart of gaussian_splat_tpu/parallel/sharded_render.py, the same scheme
over a `torch.distributed` mesh (parallel/mesh.py):

  * The GaussianModel is split over splats: each rank projects and shades its
    N/D splats into 13-float exchange records (`NFEAT_X`).
  * The records reach the band-owning ranks by one of two exchanges
    (`config.shard_exchange`):
      - "all_gather" (default): every rank gets all N records, marks the
        splats whose rect misses its band invalid, and lets at most
        `max_active` depth ranks emit pairs (N/D + margin·N,
        `RenderConfig.shard_capacity_margin`): the pair sort runs over
        ~1/D of the single-device work;
      - "all_to_all": each rank sends each band only the splats that touch
        it, in buffers of `a2a_cap` rows per (source, destination); what
        does not fit is counted in `dropped_gaussians`.
  * Each rank bins and rasterizes its horizontal band of tile rows with the
    raster kernels' band form (`tile_row0`): pixel centres are global, so
    every α is the single-device one.
  * The bands are gathered into the whole frame on every rank, and cropped
    to the true height (the frame is padded to D equal bands).

Gradients. Every rank computes the same loss on the same gathered frame, so
the frame's gather is transposed by taking this rank's rows of the (equal)
cotangent, with no sum: a summing transpose would make every gradient D
times too large. The records' all_gather is transposed by a reduce-scatter,
which sums over the bands that used each splat, and the all_to_all by the
reverse all_to_all. Each rank's gradient lands on its own block of the model,
so there is no gradient all-reduce.

Each rank's work is split into the functions below — `_pack_features`,
`_route` (the all_to_all's send buffers), `_band_inputs`, `_render_band` —
so that `render_bands_in_process` runs exactly the ranks' code for D bands
in one process (a one-device check of the sharded path).

What a rank did is kept for a reader outside the trainer (a benchmark, a
log): `torch.profiler` ranges `sharded.exchange` (the records' all_gather or
all_to_all), `sharded.exchange_bwd` (its transpose, in the backward) and
`sharded.frame_gather` (the frame's and the stats' gathers), and the module's
`counters` (`ShardCounters`), summed over `render_sharded` calls since their
`reset()`.

What differs from the reference, by design:
  * the band test `my ± ry` against the band's edges is the comparison that
    binning's rect makes (no subtraction of the band origin first), on both
    exchanges;
  * the global grid handed to binning (`total_tiles_y`) is the frame's true
    tile-row count, where the reference passes the padded one: so a K-cap
    shrink on the bottom rows is the single-device decision too;
  * compositing order: with every sentinel 0 a band's tiles hold the
    single-device pair lists in the same order, and the kernels composite a
    tile's pairs in sequence, so the image is the single-device image bit for
    bit whenever the records are the single-device rows bit for bit (the
    reference's log-space prefix sums associate differently, ~1e-7).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.profiler import record_function

from gaussian_splat_tpu_torch.camera import Camera
from gaussian_splat_tpu_torch.config import RenderConfig
from gaussian_splat_tpu_torch.ops import cuda_raster, tile_raster
from gaussian_splat_tpu_torch.ops.binning import (
    BinningStats, bin_gaussians, quantize_extent_up,
)
from gaussian_splat_tpu_torch.ops.projection import ProjectedGaussians
from gaussian_splat_tpu_torch.ops.render import _effective_opacities, _project_and_shade

NFEAT_X = 13  # exchanged floats per splat:
#   mx,my,A,B,C,depth,rx,valid,r,g,b,op,ry — rx/ry are the exact per-axis
#   ellipse-AABB extents from projection (carried bit-identically so sharded
#   tile rects — and therefore per-band pair counts — match the single-device
#   binning exactly; ry alone drives the band-intersection test)
COL_X_MY, COL_X_RX, COL_X_VALID, COL_X_OP, COL_X_RY = 1, 6, 7, 11, 12
# a band's gathered counts: BinningStats' five fields, then the records its
# binning took in and those it kept after the band test
BAND_COLS = len(BinningStats._fields) + 2
COL_BAND_IN, COL_BAND_KEPT = BAND_COLS - 2, BAND_COLS - 1


class ShardedRender(NamedTuple):
    """The whole frame on every rank, plus per-band load telemetry."""

    image: torch.Tensor  # (H, W, 3)
    t_final: torch.Tensor  # (H, W)
    depth: torch.Tensor  # (H, W)
    stats: BinningStats  # each field (D,) int32: per-band num_pairs / overflow /
    #   clamped_rects / dropped_gaussians (capacity-cap or send-buffer drops) /
    #   tier_overflow


class ShardCounters:
    """What `render_sharded` did on this rank, summed over its calls since
    `reset()` (and since the last call on a mesh of another size, which
    resets them). Host integers are counted from shapes; the band counts
    stay on the device (no synchronisation a render) until read.

      renders             render_sharded calls
      exchange_bytes      bytes this rank received in the records' exchange
      exchange_bwd_bytes  bytes it received in the exchange's transpose
      bands               (D, BAND_COLS) int64, every band's gathered row
                          (BinningStats' fields, records taken in, records
                          kept after the band test), summed over renders
      max_kept            () int64, the largest band's kept records, summed
                          over renders
    """

    def __init__(self):
        self.reset()

    def reset(self, ndev: Optional[int] = None) -> None:
        self.ndev = ndev
        self.renders = 0
        self.exchange_bytes = 0
        self.exchange_bwd_bytes = 0
        self.bands: Optional[torch.Tensor] = None
        self.max_kept: Optional[torch.Tensor] = None

    def start(self, ndev: int) -> None:
        """A render over `ndev` ranks begins."""
        if ndev != self.ndev:
            self.reset(ndev)

    def add(self, rows: torch.Tensor) -> None:
        """One render's gathered (D, BAND_COLS) rows."""
        rows = rows.to(torch.int64)
        top = rows[:, COL_BAND_KEPT].max()
        self.renders += 1
        self.bands = rows if self.bands is None else self.bands + rows
        self.max_kept = top if self.max_kept is None else self.max_kept + top

    def band_stats(self) -> Optional[BinningStats]:
        """Every band's BinningStats fields, each (D,), summed over renders."""
        if self.bands is None:
            return None
        return BinningStats(*self.bands[:, : len(BinningStats._fields)].unbind(1))


counters = ShardCounters()


def _received_bytes(t: torch.Tensor, world: int) -> int:
    """Bytes a rank receives from the other ranks when each sends one
    (1/world)-th of `t`."""
    return (world - 1) * (t.numel() // world) * t.element_size()


class BandPlan(NamedTuple):
    """The static shapes of a sharded frame."""

    ndev: int
    n: int  # splats in the whole model
    rows_per_dev: int  # tile rows a band holds
    band_h: int  # its pixel rows
    padded_h: int  # D bands' rows, ≥ the frame's height
    total_tiles_y: int  # tile rows of the frame (the global grid)
    max_active: int  # all_gather path: depth ranks a band may bin
    a2a_cap: int  # all_to_all path: rows per (source, destination)


def _band_geometry(config: RenderConfig, height: int, ndev: int) -> Tuple[int, int]:
    """(tile_rows_per_device, padded_height)."""
    ty_n = config.tiles_y(height)
    rows_per_dev = -(-ty_n // ndev)
    return rows_per_dev, rows_per_dev * ndev * config.tile_height


def band_plan(config: RenderConfig, n: int, height: int, ndev: int) -> BandPlan:
    """Band geometry and the two exchanges' capacities for n splats over
    ndev devices. The capacity floor keeps small scenes (where band-splat
    incidence is far above N/D) exact at negligible cost; at production N
    the margin and factor terms dominate."""
    rows_per_dev, padded_h = _band_geometry(config, height, ndev)
    floor = config.shard_capacity_floor
    # additive-margin cap: N/D residents + margin·N boundary-crossing tail
    cap = max(-(-n // ndev) + int(n * config.shard_capacity_margin), min(n, floor))
    max_active = min(n, -(-cap // config.chunk_size) * config.chunk_size)
    n_local = n // ndev
    a2a_cap = max(int(n_local * config.a2a_capacity_factor / ndev), min(n_local, floor))
    a2a_cap = min(n_local, -(-a2a_cap // 8) * 8)
    return BandPlan(
        ndev, n, rows_per_dev, rows_per_dev * config.tile_height, padded_h,
        config.tiles_y(height), max_active, a2a_cap,
    )


def _pack_features(model_shard, camera: Camera, config: RenderConfig) -> torch.Tensor:
    """Project + shade a model shard into (N/D, NFEAT_X) exchange records.
    The extents and the valid flag only steer binning: they are detached
    (the gradient of an extent's square root at 0 would be NaN)."""
    proj, colors = _project_and_shade(model_shard, camera, config)
    opac = _effective_opacities(model_shard, proj, config)
    extents = proj.extents.detach()
    return torch.cat(
        [
            proj.means2d,  # 0:2
            proj.conics,  # 2:5
            proj.depths[:, None],  # 5
            extents[:, 0:1],  # 6: rx
            proj.valid.to(torch.float32)[:, None],  # 7
            colors,  # 8:11
            opac[:, None],  # 11
            extents[:, 1:2],  # 12: ry
        ],
        dim=1,
    )


def _touches_band(feats: torch.Tensor, band: int, plan: BandPlan) -> torch.Tensor:
    """(rows,) bool: valid records whose rect reaches the band's pixel rows.
    ry rounded up to binning's 1/256-px grid, so the test is the comparison
    binning's rect makes (binning.quantize_extent_up)."""
    my = feats[:, COL_X_MY]
    r = quantize_extent_up(feats[:, COL_X_RY])
    lo, hi = float(band * plan.band_h), float((band + 1) * plan.band_h)
    return (feats[:, COL_X_VALID] > 0.5) & (my + r > lo) & (my - r < hi)


def _route(feats: torch.Tensor, plan: BandPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """The all_to_all's send buffers: (D, a2a_cap, NFEAT_X), row block d the
    local records that touch band d in ascending local order, then zero rows
    (valid = 0); and the () int32 count of hits that did not fit. Compacted
    by a cumsum and a scatter into fixed shapes: no host synchronisation,
    every rank sends the same shape."""
    n_local, cap = feats.shape[0], plan.a2a_cap
    dev = feats.device
    table = torch.cat([feats, feats.new_zeros((1, NFEAT_X))])  # sentinel row
    local = torch.arange(n_local, device=dev)
    sends, send_drop = [], torch.zeros((), dtype=torch.int32, device=dev)
    for d in range(plan.ndev):
        hit = _touches_band(feats, d, plan)
        place = torch.cumsum(hit, 0) - 1
        # rows that fit go to their place, the rest to a slot past the buffer
        slot = torch.where(hit & (place < cap), place, cap)
        sel = torch.full((cap + 1,), n_local, dtype=torch.int64, device=dev)
        sel.scatter_(0, slot, local)
        sends.append(table.index_select(0, sel[:cap]))
        send_drop = send_drop + torch.clamp_min(hit.sum(dtype=torch.int32) - cap, 0)
    return torch.stack(sends), send_drop


def _unpack_to_band(feats: torch.Tensor, band_valid: Optional[torch.Tensor] = None) -> ProjectedGaussians:
    """Exchange records → ProjectedGaussians, in GLOBAL pixel coordinates."""
    valid = feats[:, COL_X_VALID] > 0.5
    if band_valid is not None:
        valid = valid & band_valid
    rx, ry = feats[:, COL_X_RX], feats[:, COL_X_RY]
    return ProjectedGaussians(
        means2d=feats[:, 0:2],
        conics=feats[:, 2:5],
        depths=feats[:, 5],
        radii=torch.ceil(torch.maximum(rx, ry)).to(torch.int32),
        valid=valid,
        cov2d=feats[:, 2:5],  # placeholder (debug only)
        extents=torch.stack([rx, ry], dim=-1),
    )


def _band_raster(config: RenderConfig, device: torch.device):
    """The kernels on CUDA tensors (or raise), the plain compositor on CPU
    tensors, as `render` chooses."""
    if config.backend == "cuda" or (config.backend == "auto" and device.type == "cuda"):
        return cuda_raster.render_tiled_cuda
    return tile_raster.render_tiled


def _band_inputs(feats_band: torch.Tensor, band: int, plan: BandPlan, compact: bool):
    """Band `band`'s records as the tiled render's arguments: ((proj,
    colors, opacities), the band's keyword arguments). `compact` (the
    all_gather path): records outside the band are made invalid and at most
    `plan.max_active` depth ranks emit."""
    band_valid = _touches_band(feats_band, band, plan) if compact else None
    inputs = (_unpack_to_band(feats_band, band_valid), feats_band[:, 8:11],
              feats_band[:, COL_X_OP])
    band_args = dict(
        max_active=plan.max_active if compact else None,
        tile_row0=band * plan.rows_per_dev, total_tiles_y=plan.total_tiles_y,
    )
    return inputs, band_args


def _render_band(
    feats_band: torch.Tensor, band: int, plan: BandPlan, width: int,
    config: RenderConfig, compact: bool,
):
    """Bin and rasterize band `band` from the records it received: (image
    (band_h, W, 3), T_final, depth, BinningStats, (2,) int32 records taken in
    and records kept after the band test)."""
    inputs, band_args = _band_inputs(feats_band, band, plan, compact)
    image, t_final, depth, stats = _band_raster(config, feats_band.device)(
        *inputs, width, plan.band_h, config, **band_args
    )
    taken = torch.full((1,), feats_band.shape[0], dtype=torch.int32, device=feats_band.device)
    kept = inputs[0].valid.sum(dtype=torch.int32).reshape(1)
    return image, t_final, depth, stats, torch.cat([taken, kept])


class _Gather(torch.autograd.Function):
    """Every rank's rows stacked in rank order. The transpose is a
    reduce-scatter (the records: a sum over the ranks that used each row),
    or, when every rank's cotangent is the same (`replicated`: the frame,
    under one loss computed on every rank), this rank's own rows of it."""

    @staticmethod
    def forward(ctx, x, group, replicated):
        ctx.group, ctx.replicated = group, replicated
        world = dist.get_world_size(group)
        out = x.new_empty((world * x.shape[0], *x.shape[1:]))
        with record_function("sharded.frame_gather" if replicated else "sharded.exchange"):
            dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        if not replicated:
            counters.exchange_bytes += _received_bytes(out, world)
        return out

    @staticmethod
    def backward(ctx, grad):
        world = dist.get_world_size(ctx.group)
        rows = grad.shape[0] // world
        if ctx.replicated:
            rank = dist.get_rank(ctx.group)
            return grad[rank * rows : (rank + 1) * rows], None, None
        out = grad.new_empty((rows, *grad.shape[1:]))
        with record_function("sharded.exchange_bwd"):
            dist.reduce_scatter_tensor(out, grad.contiguous(), group=ctx.group)
        counters.exchange_bwd_bytes += _received_bytes(grad, world)
        return out, None, None


class _AllToAll(torch.autograd.Function):
    """Row block j of the result is what rank j sent to this rank; the
    transpose is the reverse all_to_all."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        with record_function("sharded.exchange"):
            dist.all_to_all_single(out, x.contiguous(), group=group)
        counters.exchange_bytes += _received_bytes(out, dist.get_world_size(group))
        return out

    @staticmethod
    def backward(ctx, grad):
        out = torch.empty_like(grad)
        with record_function("sharded.exchange_bwd"):
            dist.all_to_all_single(out, grad.contiguous(), group=ctx.group)
        counters.exchange_bwd_bytes += _received_bytes(out, dist.get_world_size(ctx.group))
        return out, None


def _stats_row(stats: BinningStats, send_drop) -> torch.Tensor:
    """(5,) int32 in BinningStats' field order, send-buffer drops added."""
    stats = stats._replace(dropped_gaussians=stats.dropped_gaussians + send_drop)
    return torch.stack([torch.as_tensor(v).to(torch.int32) for v in stats])


def _frame(bands: torch.Tensor, stats_rows: torch.Tensor, height: int) -> ShardedRender:
    """(padded_h, W, 5) stacked bands and (D, 5) stats → the cropped frame."""
    frame = bands[:height]
    return ShardedRender(
        frame[..., :3], frame[..., 3], frame[..., 4],
        BinningStats(*stats_rows[:, : len(BinningStats._fields)].unbind(1)),
    )


def _exchange(feats: torch.Tensor, plan: BandPlan, config: RenderConfig, group):
    """This rank's records for its band: (records, compact, send_drop)."""
    if config.shard_exchange == "all_gather":
        return _Gather.apply(feats, group, False), True, 0
    if config.shard_exchange == "all_to_all":
        send, send_drop = _route(feats, plan)
        return _AllToAll.apply(send.reshape(-1, NFEAT_X), group), False, send_drop
    raise ValueError(f"unknown shard_exchange {config.shard_exchange!r}")


def render_sharded(
    model,
    camera: Camera,
    config: RenderConfig,
    mesh,
    axis_name: str = "dev",
) -> ShardedRender:
    """Render with splat + tile sharding over `mesh`: called on every rank
    with that rank's block of the model (`shard_model`; equal blocks), it
    returns the whole frame, cropped to the camera's height, and the stats
    of every band, on every rank. Differentiable: the gradient reaches this
    rank's block. The camera is moved to the block's device if need be."""
    group = mesh.get_group(axis_name)
    ndev, band = mesh.size(), mesh.get_local_rank(axis_name)
    camera = camera.to(model.device)
    plan = band_plan(config, model.num_gaussians * ndev, camera.height, ndev)
    counters.start(ndev)
    feats = _pack_features(model, camera, config)
    feats_band, compact, send_drop = _exchange(feats, plan, config, group)
    image, t_final, depth, stats, records = _render_band(
        feats_band, band, plan, camera.width, config, compact
    )
    bands = _Gather.apply(
        torch.cat([image, t_final[..., None], depth[..., None]], dim=-1), group, True
    )
    row = torch.cat([_stats_row(stats, send_drop), records])
    rows = row.new_empty((ndev * row.shape[0],))
    with record_function("sharded.frame_gather"):
        dist.all_gather_into_tensor(rows, row, group=group)
    rows = rows.view(ndev, BAND_COLS)
    counters.add(rows)
    return _frame(bands, rows, camera.height)


def _records_in_process(model, camera: Camera, config: RenderConfig, plan: BandPlan):
    """The ranks' pack and exchange for plan.ndev blocks of `model`, in this
    one process: ([records band b receives], [send drops of block b]). The
    all_gather is the concatenation of the blocks' records, the all_to_all
    each block's send buffers, exchanged by indexing."""
    n, ndev = model.num_gaussians, plan.ndev
    if n % ndev:
        raise ValueError(f"{n} splats do not split into {ndev} equal blocks")
    per = n // ndev
    feats = [
        _pack_features(model.replace(
            **{k: getattr(model, k)[d * per : (d + 1) * per] for k in model.LEAVES}),
            camera, config)
        for d in range(ndev)
    ]
    if config.shard_exchange == "all_gather":
        return [torch.cat(feats)] * ndev, [0] * ndev
    if config.shard_exchange == "all_to_all":
        routed = [_route(f, plan) for f in feats]
        received = [torch.cat([send[b] for send, _ in routed]) for b in range(ndev)]
        return received, [drop for _, drop in routed]  # counted by the sender, as on ranks
    raise ValueError(f"unknown shard_exchange {config.shard_exchange!r}")


def render_bands_in_process(
    model, camera: Camera, config: RenderConfig, ndev: int
) -> ShardedRender:
    """What `render_sharded` computes on ndev ranks, run in this one process
    through the ranks' own functions: the model split into ndev blocks,
    packed and exchanged (`_records_in_process`), every band rendered, the
    bands stacked. Differentiable (autograd sums what the collectives'
    transposes sum). A one-device check of the sharded path."""
    camera = camera.to(model.device)
    plan = band_plan(config, model.num_gaussians, camera.height, ndev)
    received, drops = _records_in_process(model, camera, config, plan)
    compact = config.shard_exchange == "all_gather"
    bands, rows = [], []
    for b in range(ndev):
        image, t_final, depth, stats, records = _render_band(
            received[b], b, plan, camera.width, config, compact
        )
        bands.append(torch.cat([image, t_final[..., None], depth[..., None]], dim=-1))
        rows.append(torch.cat([_stats_row(stats, drops[b]), records]))
    return _frame(torch.cat(bands), torch.stack(rows), camera.height)


@torch.no_grad()
def sharded_binning_stats(
    model,
    camera: Camera,
    config: RenderConfig,
    mesh,
    axis_name: str = "dev",
    sigma_test: bool = True,
) -> BinningStats:
    """Project → exchange → bin (NO raster): per-band BinningStats, each
    field (D,), on every rank. The sharded data path — the exchange, band
    compaction, pair expansion, sort, segment boundaries — at target shapes
    without rendering; `sigma_test` runs the σ-bound cell test as the render
    path does."""
    group = mesh.get_group(axis_name)
    ndev, band = mesh.size(), mesh.get_local_rank(axis_name)
    camera = camera.to(model.device)
    plan = band_plan(config, model.num_gaussians * ndev, camera.height, ndev)
    feats = _pack_features(model, camera, config)
    feats_band, compact, send_drop = _exchange(feats, plan, config, group)
    (proj, _colors, opacities), band_args = _band_inputs(feats_band, band, plan, compact)
    b = bin_gaussians(
        proj, camera.width, plan.band_h, config,
        opacities=opacities if sigma_test else None, **band_args,
    )
    row = _stats_row(BinningStats.of(b), send_drop)
    rows = row.new_empty((ndev * row.shape[0],))
    dist.all_gather_into_tensor(rows, row, group=group)
    return BinningStats(*rows.view(ndev, -1).unbind(1))
