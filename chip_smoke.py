"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                     # every phase; one card is enough
    python3 chip_smoke.py --only multi_gpu    # the multi-card phase alone

Drives the port's paths on the GPU through the entry points a user calls —
serving frames, training, the interactive viewer, and the sharded path —
builds every hand-written CUDA kernel from csrc/, holds each against its
plain PyTorch version on the card, and shows that each path went through its
kernels (launch counts, set to 0 just before a path and read just after it).
One JSON object per line:

  env        GPU name and power limit (as nvidia-smi prints them), versions
  build      seconds to build csrc/, the libraries, the compiler's report
  golden     tests/golden/scene.ply rendered with backend="cuda" vs golden.npy
  golden_grad  the five parameter gradients of a seeded loss on that scene,
             backend "cuda" (the kernels) vs "torch_tile" (autograd)
  no_fallback  a failed build of any kernel raises out of a training step
  main_path  1M-splat scene at 1920x1080 through Viewer.render_frame
  train_path same scene through fit (one view) and fit_multiview_adc (four
             views, a densify, a checkpoint and a resume), with the step's
             time and its split by stage
  view_path  the interactive viewer on the same scene: written to a PLY and
             loaded back by the native reader (timed against numpy); a
             Viewer with the grid/axes overlay and the pair-budget drag LoD
             (and a second subset valued by measure_splat_contributions);
             serve() driven over HTTP (full frames, a drag, modes, overlay
             toggle, resize), the JPEG encode timed apart; kernel hot reload
             on a temporary copy of csrc/ (a comment: rebuilt under a new
             hash, the same frame; a syntax error: refused, the last good
             build keeps serving); one frame under the profiler trace, with
             the device's busy share of it
  band_path  the sharded path on one card: the same scene as 4 bands in one
             process through the ranks' own functions, both exchanges, held
             against the single-card frame (bitwise, or within ATOL/RTOL
             where the records differ, said so) and gradients; every band's
             sentinels 0, 4 launches of each kernel a frame; per band its
             pairs and the band kernels' times
  kernels    each kernel vs its plain version: errors, times, bound (from
             gaussian_splat_tpu_torch/utils/roofline.py), launches on each
             path; the raster kernels' own count of kept steps vs the plain
             count (their per-warp cull dropped nothing) and the share of
             (warp, pair)s the cull let through; rank_perm's permutation vs
             the rank sort (equal, element for element), segsum also on a
             ragged full-size case; the SH kernels on random rows (K = 16
             and 9, degrees 1-3) up to 1M and 11.2M rows, beside their plain
             versions and autograd through the plain forward; the projection
             kernels on random rows at 1M and 11.2M (the forward bitwise its
             plain version, radii, valid and extents included; the backward
             under a train step's cotangents), beside the same. `ms` =
             `kernel_ms`, one call per event pair (the host's time to issue
             it included); beside it
             `kernel_ms_back_to_back` (calls issued back to back) and, for
             every kernel, the profiler's `device_ms` (and the bound's share
             of both)
             Band cases (tile_row0 > 0) at small shapes and at full size.
             binning's chain (csrc/binning.cu, one entry) on the small
             scenes, the bench frame, its band 2 of 4, a random scene of
             rubble's 11.2M rows at 1152x864, and scenes with a tail of
             large splats at the caps calibration gives (the frame's tiles:
             1944 at 1152x864, 1085 at 979x546; MAX_K_BIG past 8192 tiles):
             every output field bit for bit the plain version's on the
             card, beside its time and each kernel's device time
  cli        `cli render`, `cli train`, `cli view` (served over HTTP, then
             terminated) and `cli validate` as subprocesses
  multi_gpu  with two cards or more: one process a card over NCCL,
             make_mesh -> shard_model -> render_sharded at full width, both
             exchanges (rank 0's frame vs the single card's, stats of every
             band, gradients gathered to rank 0, two runs bitwise equal, a
             tiny all_to_all buffer reporting its drops), fit(mesh=) for a
             few steps against the single card's fit; frame, step and
             exchange times. With one card: {"phase": "multi_gpu", "ran":
             false, "cards": 1}
  last line  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Any failed check raises: the process exits non-zero and prints no last line.
Without a GPU it exits with code 2 before running anything.
"""

import argparse
import copy
import dataclasses
import io
import json
import os
import queue
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device available", file=sys.stderr)
    sys.exit(2)

from gaussian_splat_tpu_torch import (  # noqa: E402
    Camera, GaussianModel, RenderConfig, TrainConfig, _build,
    calibrate_render_config, fit, fit_multiview_adc, render,
)
from gaussian_splat_tpu_torch.camera import orbit_camera  # noqa: E402
from gaussian_splat_tpu_torch.io import ply  # noqa: E402
from gaussian_splat_tpu_torch.io.ply import load_gaussians, save_gaussians  # noqa: E402
from gaussian_splat_tpu_torch.ops import cuda_raster, tile_raster  # noqa: E402
from gaussian_splat_tpu_torch.ops import projection as proj_ops  # noqa: E402
from gaussian_splat_tpu_torch.ops import sh as sh_ops  # noqa: E402
from gaussian_splat_tpu_torch.ops import binning as binning_ops  # noqa: E402
from gaussian_splat_tpu_torch.ops.binning import (  # noqa: E402
    bin_gaussians, bin_gaussians_torch, quantize_extent_up, rank_permutation_by_mask,
)
from gaussian_splat_tpu_torch.ops.render import (  # noqa: E402
    _effective_opacities, _project_and_shade, measure_pair_costs,
    measure_splat_contributions,
)
from gaussian_splat_tpu_torch.parallel import sharded_render as sharded  # noqa: E402
from gaussian_splat_tpu_torch.train import trainer  # noqa: E402
from gaussian_splat_tpu_torch.train.checkpoint import (  # noqa: E402
    latest_step, restore_checkpoint,
)
from gaussian_splat_tpu_torch.train.dataset import orbit_dataset  # noqa: E402
from gaussian_splat_tpu_torch.train.loss import photometric_loss  # noqa: E402
from gaussian_splat_tpu_torch.utils import roofline  # noqa: E402
from gaussian_splat_tpu_torch.utils.timing import trace  # noqa: E402
from gaussian_splat_tpu_torch.viewer.trackball import TrackballCamera  # noqa: E402
from gaussian_splat_tpu_torch.viewer.viewer import Viewer, encode_jpeg  # noqa: E402

DEVICE = "cuda"
# full size: the bench scene of the JAX package (bench.py) — 1M splats, 1080p
N_SPLATS, WIDTH, HEIGHT = 1_000_000, 1920, 1080
ORBIT_FRAMES = 8
ATOL, RTOL = 3e-5, 1e-4  # forward kernel vs plain version, per channel
# Gradients, per column: |got − want| ≤ rtol·|want| + atol_rel·max|want of that
# column|, under cotangents of unit scale (under a mean loss they are ~1e-7
# and a fixed atol would pass anything)
GRAD_RTOL, GRAD_ATOL_REL = 3e-3, 5e-6
GOLDEN_LIMIT = 2e-3
FIT_STEPS, ADC_STEPS, ADC_RESUME_STEPS, ADC_VIEWS = 6, 6, 8, 4
LOD_PAIRS = 0.1  # the viewer's drag budget: a tenth of the frame's pair cost
BANDS = 4  # the sharded path's target layout: 4 cards, 17 of the 68 tile rows each
FULL_BAND = 2  # the full-size band case of the kernels line: tile_row0 = 34
FULL_BAND_CASE = f"bench_full_band{FULL_BAND}of{BANDS}"
SMALL_BAND_CASES = ("random120_96x64", "deep200_64x64", "random120_100x70_tiles20x10")
# the SH kernels' cases: (name, rows, coefficients a row, degree); bench_full
# is the bench scene's size at degree 3, rubble_rows the rubble cell's
# (splatbench/configs/rubble.json)
SH_CASES = (("rows1_k16_d3", 1, 16, 3), ("rows255_k9_d2", 255, 9, 2),
            ("ragged_k16_d1", 1_000_003, 16, 1), ("bench_full", N_SPLATS, 16, 3),
            ("rubble_rows", 11_200_000, 16, 3))
# where the SH colour before its clamp lies this close to 0, rounding decides
# whether the gradient passes: those rows are left out of the comparison
SH_KINK = 1e-4
# the projection kernels' cases: (name, rows), opacity-aware extents (the
# render default) at rubble's 1152x864 camera; bench_full is the bench
# scene's size, rubble_rows the rubble cell's
PROJ_CASES = (("rows1000", 1_000), ("bench_full", N_SPLATS), ("rubble_rows", 11_200_000))
# a train step's cotangents of the projection: the raster stage's and SH's
PROJ_TRAIN_COTANGENTS = ("means2d", "conics", "depths", "dirs")
# proj_bwd may be past the gradient tolerance of the float64 plain backward
# on this many times the elements that the float32 plain backward is
PROJ_SLACK = 1.05
# binning's cases at rubble's size: its rows, frame and the train mix's K
# (splatbench/configs/rubble.json, traffic/train.json), which calibration
# raises to the frame's 1944 tiles
RUBBLE_ROWS, RUBBLE_W, RUBBLE_H, RUBBLE_K = 11_200_000, 1152, 864, 256
# binning's cases at the caps calibration gives the main paths (the frame's
# tiles, at most MAX_K_BIG): (name, rows, width, height, big_headroom), a
# random scene whose first TAIL_ROWS splats span up to the whole frame; at
# 3840x2160 (16,200 tiles) the cap is MAX_K_BIG and the largest rects shrink
BIG_K_CASES = (("rubble_k_frame", RUBBLE_ROWS, RUBBLE_W, RUBBLE_H, 1.2),
               ("truck_k_frame", 1_657_258, 979, 546, 1.2),
               ("k_max_big", 250_000, 3840, 2160, 1.2))
TAIL_ROWS = 4096
TAIL_SCALES = (0.005, 0.5)  # the tail's scales, log-uniform
MULTI_GPU_TIMEOUT = 900  # seconds for every rank of the multi_gpu phase to finish
FIT_TRACK_RTOL = 1e-3  # fit(mesh=)'s losses against the single card's, relative
SENTINELS = ("overflow", "tier_overflow", "dropped_gaussians")  # must be 0 on every band
JPEG_PSNR_MIN = 35.0  # dB: a served frame, decoded, vs render_frame's pixels
HTTP_TIMEOUT = 120  # seconds, every socket operation and the CLI's start-up
FULL_FRAMES = 4  # full frames served before the drag


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, message):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {message}")


def time_ms(fn, reps, warmup=1):
    """Median milliseconds of fn(), by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_back_to_back_ms(fn, reps, calls=20):
    """Median milliseconds per call of `calls` calls of fn() issued back to
    back between two CUDA events: the device's time per call once the host
    keeps ahead of it (time_ms also counts the host's time to issue the one
    call while the device waits)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def device_ms(fn, calls=10):
    """Milliseconds per call of the device activity (kernels, copies, fills)
    that fn() issues, by the profiler: the device's own time, with no host
    time in it. fn is called once before."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    # None where the trace holds no device activity: not measured, not 0
    return sum(t.end - t.start for t in spans) / 1e3 / calls if spans else None


# -- scenes -------------------------------------------------------------------


def bench_scene():
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    model = GaussianModel.random(
        gen, N_SPLATS, sh_degree=1, extent=2.0, scale_range=(0.005, 0.02),
        device=DEVICE,
    )
    camera = Camera.from_lookat(
        (0.0, 0.5, -5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 60.0, WIDTH, HEIGHT,
        device=DEVICE,
    )
    return model, camera


def degenerate_conics(table):
    """The table with every third row's B raised to 1.2·√(A·C) (det < 0) and
    every seventh's to √(A·C) (det = 0 up to rounding): rows that no
    projection makes, whose extent must come out infinite."""
    table = table.clone()
    root = torch.sqrt(table[:, tile_raster.COL_A] * table[:, tile_raster.COL_C])
    table[::3, tile_raster.COL_B] = 1.2 * root[::3]
    table[::7, tile_raster.COL_B] = root[::7]
    return table


def small_scenes():
    """(name, model, camera, config, tamper): the two small shapes of the JAX
    kernel tests, one with other tiles, and three aimed at the raster kernels'
    layout rule and per-warp cull. `tamper`, where not None, rewrites the
    splat table before the kernels and their plain versions see it."""
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    rand = GaussianModel.random(
        gen, 120, sh_degree=1, extent=1.2, scale_range=(0.02, 0.1), device=DEVICE
    )
    n = 200  # all in one tile, dim: a segment of several shared-memory batches
    rng = np.random.RandomState(0)
    deep = GaussianModel.create(
        means=0.05 * rng.randn(n, 3),
        quats=np.tile([1.0, 0.0, 0.0, 0.0], (n, 1)),
        log_scales=np.full((n, 3), np.log(0.02)),
        opacity_logits=np.full((n,), -2.0),
        sh=rng.uniform(-0.5, 1.5, (n, 1, 3)),
        device=DEVICE,
    )

    # one splat far larger than a tile (its extent covers every warp of every
    # tile it is listed in) in front of small ones
    m = 60
    huge = GaussianModel.create(
        means=np.concatenate([[[0.0, 0.0, -0.5]], 0.8 * rng.randn(m, 3)]),
        quats=np.tile([1.0, 0.0, 0.0, 0.0], (m + 1, 1)),
        log_scales=np.concatenate([np.full((1, 3), np.log(1.5)),
                                   np.full((m, 3), np.log(0.05))]),
        opacity_logits=np.concatenate([[-1.0], np.full((m,), 1.0)]),
        sh=rng.uniform(-0.5, 1.5, (m + 1, 1, 3)),
        device=DEVICE,
    )

    def cam(w, h):
        return Camera.from_lookat(
            (0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, w, h, device=DEVICE
        )

    return [
        ("random120_96x64", rand, cam(96, 64), RenderConfig(), None),
        ("deep200_64x64", deep, cam(64, 64), RenderConfig(), None),
        # another tile shape, and an image whose right and bottom edges are ragged
        ("random120_100x70_tiles16x16", rand, cam(100, 70),
         RenderConfig(tile_width=16, tile_height=16), None),
        # tile_w % 8 != 0: the row-major branch of the layout rule (200 threads
        # a block in raster_fwd, 224 in raster_bwd)
        ("random120_100x70_tiles20x10", rand, cam(100, 70),
         RenderConfig(tile_width=20, tile_height=10), None),
        ("huge1_small60_96x64", huge, cam(96, 64), RenderConfig(), None),
        ("random120_96x64_det_le_0", rand, cam(96, 64), RenderConfig(), degenerate_conics),
    ]


# -- phases -------------------------------------------------------------------


def phase_env():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("env", gpu=smi, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])
    return smi


def phase_build():
    info = _build.build_all()
    check(set(info["libraries"]) == set(_build.kernel_names()), "a kernel did not build")
    used = {n: [ln for ln in rep.splitlines() if "registers" in ln or "spill" in ln]
            for n, rep in info["reports"].items()}
    emit("build", seconds=info["seconds"], libraries=info["libraries"], ptxas=used)


@torch.no_grad()
def phase_golden():
    golden = np.load(os.path.join(ROOT, "tests", "golden", "golden.npy")).astype(np.float32)
    model = load_gaussians(os.path.join(ROOT, "tests", "golden", "scene.ply"), device=DEVICE)
    cam = Camera.from_lookat(
        (0.0, 1.2, -2.6), (0, 0, 0), (0, 1, 0), 50.0, 160, 120, device=DEVICE
    )
    cfg = RenderConfig(backend="cuda", background=(0.05, 0.05, 0.08))
    img = render(model, cam, cfg).image.cpu().numpy()
    err = float(np.abs(img - golden).max())
    emit("golden", max_abs_err=err, limit=GOLDEN_LIMIT, backend=cfg.backend)
    check(np.isfinite(img).all() and err < GOLDEN_LIMIT, f"golden image off by {err}")


@torch.no_grad()
def raster_inputs(model, camera, config):
    """One frame's stages up to the raster's inputs, as the main path builds
    them: (proj, colors, opacities), binning, the raster stage's arguments."""
    proj, colors = _project_and_shade(model, camera, config)
    opacities = _effective_opacities(model, proj, config)
    binning, table = tile_raster.bin_and_table(
        proj, colors, opacities, camera.width, camera.height, config)
    args = (table, binning.pair_gauss, binning.tile_offsets, binning.tile_counts)
    return (proj, colors, opacities), binning, args


@torch.no_grad()
def band_inputs(model, camera, config, ndev, band, exchange="all_gather"):
    """Band `band` of `ndev` through the sharded path's own functions, in
    this process: the model's blocks packed and exchanged, the band's
    records made the tiled render's inputs (`sharded_render._band_inputs`).
    Returns ((proj, colors, opacities), band keyword arguments, config,
    band_h)."""
    cfg = dataclasses.replace(config, shard_exchange=exchange)
    plan = sharded.band_plan(cfg, model.num_gaussians, camera.height, ndev)
    received = sharded._records_in_process(model, camera, cfg, plan)[0][band]
    inputs, band_args = sharded._band_inputs(received, band, plan, exchange == "all_gather")
    return inputs, band_args, cfg, plan.band_h


@torch.no_grad()
def band_raster_inputs(model, camera, config, ndev, band, exchange="all_gather"):
    """Band `band` of `ndev` (`band_inputs`), binned and tabled. Returns
    (binning, raster args, tile_row0, band_h)."""
    inputs, band_args, cfg, band_h = band_inputs(model, camera, config, ndev, band, exchange)
    binning, table = tile_raster.bin_and_table(
        *inputs, camera.width, band_h, cfg, **band_args)
    args = (table, binning.pair_gauss, binning.tile_offsets, binning.tile_counts)
    return binning, args, band_args["tile_row0"], band_h


@torch.no_grad()
def count_steps(args, walked, width, height, config, tile_row0=0):
    """The (pixel, pair) steps that this run's data asks of raster_fwd, counted
    in plain torch over the pairs each tile walked before it left its loop
    (`walked`, read back from the kernel) and the pixels inside the image (a
    band's `height` rows from tile row `tile_row0`): (all steps, steps that
    pass the keep test, (warp, pair)s that the plain mirror of the kernels'
    per-warp cull lets through)."""
    table, pair_gauss, tile_offsets, tile_counts = args
    tx_n = config.tiles_x(width)
    tw, th = config.tile_width, config.tile_height
    y_end = tile_row0 * th + height  # the band's last pixel row, global, + 1
    steps = kept = live_warp_pairs = 0
    for t0, t1 in tile_raster.tile_batches(tile_offsets, tile_counts, 1 << 16):
        rows, local_tile, start, px, py, sigma = tile_raster.pair_pixel_sigma(
            table, pair_gauss, tile_offsets, tile_counts, tx_n, config, (t0, t1),
            tile_row0,
        )
        tile = local_tile + t0
        index_in_tile = (
            torch.arange(rows.shape[0], device=rows.device) + start - tile_offsets[tile]
        )
        live = (index_in_tile < walked[tile])[:, None] & (px < width) & (py < y_end)
        bound = rows[:, tile_raster.COL_BOUND : tile_raster.COL_BOUND + 1]
        steps += int(live.sum())
        kept += int((live & (sigma >= 0.0) & (sigma <= bound)).sum())
        # each warp's pixel-centre rectangle in the pair's tile: (b, warps)
        miss = tile_raster.extent_misses_rect(
            tile_raster.splat_extent_torch(rows)[:, None, :],
            *tile_raster.warp_pixel_rects(tile, tx_n, tw, th, tile_row0))
        live_warp_pairs += int((~miss & (index_in_tile < walked[tile])[:, None]).sum())
    return steps, kept, live_warp_pairs


def grad_errors(got, want, floor=0.0):
    """(max abs error, elements over tolerance) of a gradient, column by
    column (the last axis), by GRAD_RTOL and GRAD_ATOL_REL; `floor` is a
    magnitude that a column's own maximum is raised to."""
    got2, want2 = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    err = (got2 - want2).abs()
    scale = want2.abs().amax(dim=0, keepdim=True).clamp_min(floor)
    tol = GRAD_RTOL * want2.abs() + GRAD_ATOL_REL * scale
    return float(err.max()) if err.numel() else 0.0, int((err > tol).sum())


def grad_errors_against(got, plain, truth):
    """A float32 gradient `got` and the plain float32 version's `plain`,
    both against `truth`, the plain version in float64, by GRAD_RTOL and
    GRAD_ATOL_REL: on ill-conditioned rows both stray from the exact value,
    each by its own rounding. `n_over` counts the elements past the
    tolerance beyond the plain version's count within its noise (PROJ_SLACK
    times it, three standard deviations of a count, and 3), and the NaNs
    where the plain version has none."""
    nan = got.isnan() != plain.isnan()
    ok = ~(plain.isnan() | truth.isnan() | got.isnan())
    g, p, t = got[ok].double(), plain[ok].double(), truth[ok]
    col = torch.where(ok, truth.abs(), 0.0).reshape(-1, truth.shape[-1]).amax(dim=0)
    scale = col.expand(ok.shape)[ok] if t.numel() else t
    tol = GRAD_RTOL * t.abs() + GRAD_ATOL_REL * scale
    over, plain_over = int(((g - t).abs() > tol).sum()), int(((p - t).abs() > tol).sum())
    return {"max_abs_err": float((g - t).abs().max()) if t.numel() else 0.0,
            "plain_max_abs_err": float((p - t).abs().max()) if t.numel() else 0.0,
            "over": over, "plain_over": plain_over,
            "n_over": max(0, over - int(PROJ_SLACK * plain_over + 3 * plain_over ** 0.5 + 3))
            + int(nan.sum())}


@torch.no_grad()
def compare_kernels(name, model, camera, config, reps, tamper=None, band=None):
    """The four kernels vs their plain versions on one frame's binning:
    {kernel name: case}. The backward kernels get seeded cotangents of unit
    scale, and are run twice to show that their results are bitwise equal.
    Both raster kernels also count their kept steps and the (warp, pair)s
    their cull let through; the first must equal the plain count. `band`
    (ndev, b): band b of ndev as the sharded path bins it (tile_row0 > 0 for
    b > 0), the band form of the raster kernels."""
    w = camera.width
    if band is None:
        _, binning, args = raster_inputs(model, camera, config)
        row0, h = 0, camera.height
    else:
        binning, args, row0, h = band_raster_inputs(model, camera, config, *band)
    if tamper is not None:
        args = (tamper(args[0]), *args[1:])
    table, pair_gauss, tile_offsets, tile_counts = args
    rank_starts = binning.rank_starts
    n = binning.num_active  # the table's rows
    pairs = int(binning.num_pairs) - int(binning.overflow)
    shape = {"case": name, "n_splats": model.num_gaussians, "table_rows": n,
             "width": w, "height": h, "tile_row0": row0, "pairs": pairs}

    # -- raster_fwd --------------------------------------------------------
    walked = torch.zeros_like(tile_counts)
    n_tiles = tile_counts.numel()
    counted = torch.zeros((n_tiles, 2), dtype=torch.int32, device=DEVICE)
    rgbd, t_final = cuda_raster.raster_forward(
        *args, w, h, config, walked=walked, counters=counted, tile_row0=row0)
    plain_rgbd, plain_t = cuda_raster.raster_forward(*args, w, h, config, tile_row0=row0)
    want = tile_raster.raster_forward_torch(*args, w, h, config, row0)
    torch.cuda.synchronize()
    got_all = torch.cat([rgbd, t_final[..., None]], dim=-1)
    want_all = torch.cat([want[0], want[1][..., None]], dim=-1)
    check(bool(torch.isfinite(got_all).all()), f"{name}: raster_fwd output not finite")
    err = (got_all - want_all).abs()
    over = (err > ATOL + RTOL * want_all.abs()).any(dim=-1)
    steps, kept_steps, live_plain = count_steps(args, walked, w, h, config, row0)
    warps = -(-config.tile_pixels // 32)
    warp_pairs = int(walked.sum()) * warps

    def cull_fields(kernel, counted):
        """What a kernel counted, held against the plain count."""
        kept, live = (int(v) for v in counted.sum(dim=0, dtype=torch.int64))
        check(kept == kept_steps,
              f"{name}: {kernel} counted {kept} kept steps, the plain count is "
              f"{kept_steps}: its cull dropped or invented steps")
        check(live == live_plain,
              f"{name}: {kernel}'s cull let {live} (warp, pair)s through, its plain "
              f"mirror tile_raster.splat_extent_torch {live_plain}")
        return {
            "kept_steps_counted": kept, "warp_pairs": warp_pairs,
            "live_warp_pairs": live, "live_warp_pairs_plain": live_plain,
            "live_warp_pair_share": live / warp_pairs if warp_pairs else 0.0,
        }

    check(torch.equal(rgbd, plain_rgbd) and torch.equal(t_final, plain_t),
          f"{name}: raster_fwd with and without counters differ")
    fwd = {
        **shape, "walked_pairs": int(walked.sum()), "steps": steps,
        "kept_steps": kept_steps, **cull_fields("raster_fwd", counted),
        "max_abs_err": float(err.max()), "n_over": int(over.sum()),
        "kernel_ms": time_ms(
            lambda: cuda_raster.raster_forward(*args, w, h, config, tile_row0=row0), reps),
        "kernel_ms_back_to_back": time_back_to_back_ms(
            lambda: cuda_raster.raster_forward(*args, w, h, config, tile_row0=row0), reps),
        "device_ms": device_ms(
            lambda: cuda_raster.raster_forward(*args, w, h, config, tile_row0=row0)),
        "plain_ms": time_ms(
            lambda: tile_raster.raster_forward_torch(*args, w, h, config, row0),
            max(1, reps // 4), warmup=0),
        # each input read once, each output written once; the operations that
        # this run's data needs
        **roofline.forward_cost(n, pairs, n_tiles, w, h, steps, kept_steps).fields(),
    }

    # -- raster_bwd --------------------------------------------------------
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    d_rgbd = torch.randn((h, w, 4), generator=gen, device=DEVICE)
    d_t = torch.randn((h, w), generator=gen, device=DEVICE)
    bwd_args = (*args, rgbd, t_final, d_rgbd, d_t, w, h, config)
    counted = torch.zeros_like(counted)
    rows = cuda_raster.raster_backward(
        *bwd_args, walked=walked, counters=counted, tile_row0=row0)
    rows_again = cuda_raster.raster_backward(*bwd_args, walked=walked, tile_row0=row0)
    t0 = time.perf_counter()
    want_rows = tile_raster.raster_backward_torch(*bwd_args, walked=walked, tile_row0=row0)
    torch.cuda.synchronize()
    plain_bwd_ms = (time.perf_counter() - t0) * 1e3
    check(bool(torch.isfinite(rows).all()), f"{name}: raster_bwd output not finite")
    bwd_err, bwd_over = grad_errors(rows[:, :10], want_rows)
    tail_clean = not bool(rows[:, 10:].any()) and not bool(rows[pairs:].any())
    num_rows = rows.shape[0]
    bwd = {
        **shape, "rows": num_rows, "steps": steps, "kept_steps": kept_steps,
        **cull_fields("raster_bwd", counted),
        "max_abs_err": bwd_err, "n_over": bwd_over,
        "bitwise_repeatable": bool(torch.equal(rows, rows_again)),
        "pad_columns_and_rows_zero": tail_clean,
        "kernel_ms": time_ms(
            lambda: cuda_raster.raster_backward(*bwd_args, walked=walked, tile_row0=row0),
            reps),
        "kernel_ms_back_to_back": time_back_to_back_ms(
            lambda: cuda_raster.raster_backward(*bwd_args, walked=walked, tile_row0=row0),
            reps),
        "device_ms": device_ms(
            lambda: cuda_raster.raster_backward(*bwd_args, walked=walked, tile_row0=row0)),
        "plain_ms": plain_bwd_ms,
        **roofline.backward_cost(
            n, pairs, n_tiles, w, h, num_rows, steps, kept_steps).fields(),
    }

    # -- rank_perm (the backward's rank order, from binning's own sort) ------
    kept = binning.kept
    sort_args = (binning.pair_src, rank_starts, kept, config)

    def rank_perm():
        return cuda_raster.rank_permutation_from_sort(*sort_args)

    perm, perm_again = rank_perm(), rank_perm()
    plain_perm = rank_permutation_by_mask(*sort_args)
    keyed = torch.where(torch.arange(num_rows, device=DEVICE) < pairs, pair_gauss, n)
    rank = {
        **shape, "rows": num_rows,
        # integers: exact, or wrong
        "max_abs_err": float((perm - plain_perm).abs().max()) if num_rows else 0.0,
        "n_over": int((perm != plain_perm).sum()),
        "equals_rank_sort": bool(torch.equal(
            perm, tile_raster.rank_permutation(pair_gauss, rank_starts, n))),
        "bitwise_repeatable": bool(torch.equal(perm, perm_again)),
        "kernel_ms": time_ms(rank_perm, reps),
        "kernel_ms_back_to_back": time_back_to_back_ms(rank_perm, reps),
        "device_ms": device_ms(rank_perm),
        "plain_ms": time_ms(lambda: rank_permutation_by_mask(*sort_args), reps),
        # the yardstick: ONE stable sort of the keyed ranks
        "library_ms": time_ms(lambda: torch.sort(keyed, stable=True), reps),
        "rank_sort_ms": time_ms(
            lambda: tile_raster.rank_permutation(pair_gauss, rank_starts, n), reps),
        # the real pairs' slots, the kept cells, the big rows' ranks and
        # rank_starts read once, the permutation written once
        **roofline.rank_perm_cost(
            n, pairs, num_rows, kept.small.numel() + kept.big.numel(),
            kept.big_ranks.numel()).fields(),
    }

    # -- segsum (on the rows the backward kernel made, through rank_perm's
    # permutation) ------------------------------------------------------------
    d_table = cuda_raster.segment_sum(rows, perm, rank_starts, n)
    d_table_again = cuda_raster.segment_sum(rows, perm, rank_starts, n)
    want_table = tile_raster.segment_sum_torch(rows, perm, rank_starts, n)
    seg_err, seg_over = grad_errors(d_table, want_table)
    # the yardstick: ONE index_add_ of the same rows by their keyed rank
    keys = torch.where(
        torch.arange(num_rows, device=DEVICE) < pairs, pair_gauss.long(), n)
    lib_out = torch.zeros((n + 1, cuda_raster.ROW_COLS), device=DEVICE)

    def library():
        lib_out.zero_()
        lib_out.index_add_(0, keys, rows)

    library()
    lib_err, lib_over = grad_errors(d_table, lib_out[:n])
    seg = {
        **shape, "rows": num_rows,
        "max_abs_err": seg_err, "n_over": seg_over,
        "max_abs_err_vs_library": lib_err, "n_over_vs_library": lib_over,
        "bitwise_repeatable": bool(torch.equal(d_table, d_table_again)),
        "perm_equals_rank_sort": rank["equals_rank_sort"],
        "kernel_ms": time_ms(
            lambda: cuda_raster.segment_sum(rows, perm, rank_starts, n), reps),
        "kernel_ms_back_to_back": time_back_to_back_ms(
            lambda: cuda_raster.segment_sum(rows, perm, rank_starts, n), reps),
        "device_ms": device_ms(lambda: cuda_raster.segment_sum(rows, perm, rank_starts, n)),
        "plain_ms": time_ms(
            lambda: tile_raster.segment_sum_torch(rows, perm, rank_starts, n), reps),
        "library_ms": time_ms(library, reps),
        "perm_ms": rank["kernel_ms"], "rank_sort_ms": rank["rank_sort_ms"],
        # rows and int32 permutation of the real pairs read once, rank_starts
        # read once, the table's gradient written once; one addition per value
        # read
        **roofline.segsum_cost(n, pairs).fields(),
    }
    return {"raster_fwd": fwd, "raster_bwd": bwd, "rank_perm": rank, "segsum": seg}


@torch.no_grad()
def ragged_segments():
    """(rows, perm, rank_starts, n, lengths) at full size, ragged: most ranks
    empty (and the last tenth, as culled splats are), segments of 1-6 and of
    32 pairs side by side, a stretch of 2,000 segments of 32, one of 5,000
    (far past max_tiles_per_gaussian and past many warps' runs), junk in the
    padding rows."""
    n = N_SPLATS
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    u = torch.rand((n,), generator=gen, device=DEVICE)
    short = torch.randint(1, 7, (n,), generator=gen, device=DEVICE)
    lengths = torch.where(u < 0.6, 0, torch.where(u < 0.9, short, 32))
    lengths[n // 2 : n // 2 + 2000] = 32
    lengths[n // 3] = 5000
    lengths[-(n // 10):] = 0
    rank_starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=DEVICE),
                             torch.cumsum(lengths, 0)]).to(torch.int32)
    pairs = int(rank_starts[-1])
    num_rows = pairs + 4096
    perm = torch.randperm(num_rows, generator=gen, device=DEVICE).to(torch.int32)
    rows = torch.randn((num_rows, cuda_raster.ROW_COLS), generator=gen, device=DEVICE)
    return rows, perm, rank_starts, n, lengths


@torch.no_grad()
def segsum_ragged(reps):
    """segsum on `ragged_segments`: against the plain version, twice bitwise,
    empty ranks zero, and the owner rule's plain mirror giving every rank one
    warp."""
    rows, perm, rank_starts, n, lengths = ragged_segments()
    pairs, num_rows = int(rank_starts[-1]), rows.shape[0]
    runs = tile_raster.segsum_runs(rank_starts, n, num_rows)
    got = cuda_raster.segment_sum(rows, perm, rank_starts, n)
    again = cuda_raster.segment_sum(rows, perm, rank_starts, n)
    err, over = grad_errors(got, tile_raster.segment_sum_torch(rows, perm, rank_starts, n))
    return {
        "case": "ragged_full", "n_splats": n, "pairs": pairs, "rows": num_rows,
        "empty_ranks": int((lengths == 0).sum()), "longest_segment": int(lengths.max()),
        "max_abs_err": err, "n_over": over,
        "bitwise_repeatable": bool(torch.equal(got, again)),
        "empty_ranks_zero": not bool(got[lengths == 0].any()),
        "warp_runs": runs.shape[0],
        "owned_once": bool(int(runs[:, 1].sum()) == n and torch.equal(
            runs[1:, 0], runs[:-1, 0] + runs[:-1, 1])),
        "kernel_ms": time_ms(lambda: cuda_raster.segment_sum(rows, perm, rank_starts, n), reps),
        "kernel_ms_back_to_back": time_back_to_back_ms(
            lambda: cuda_raster.segment_sum(rows, perm, rank_starts, n), reps),
        "device_ms": device_ms(lambda: cuda_raster.segment_sum(rows, perm, rank_starts, n)),
        **roofline.segsum_cost(n, pairs).fields(),
    }


@torch.no_grad()
def compare_sh(name, n, k, degree, reps, seed):
    """sh_fwd and sh_bwd vs their plain versions on n random rows of k
    coefficients and unit directions, seeded cotangents of unit scale:
    {kernel name: case}. Both run twice (bitwise equal); the gradient of the
    coefficients the degree leaves unused must be exactly zero, and rows at
    the clamp's kink (SH_KINK) are left out of the gradients' errors. Beside
    each kernel's times: its plain version's, and for the backward autograd's
    forward and backward through the plain forward (the stage the kernels
    replaced)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    sh = torch.randn((n, k, 3), generator=gen, device=DEVICE)
    dirs = torch.nn.functional.normalize(
        torch.randn((n, 3), generator=gen, device=DEVICE), dim=-1)
    cot = torch.randn((n, 3), generator=gen, device=DEVICE)
    shape = {"case": name, "n_splats": n, "coefficients": k, "degree": degree}

    def fwd_kernel():
        return sh_ops.sh_forward(degree, sh, dirs)

    def bwd_kernel():
        return sh_ops.sh_backward(degree, sh, dirs, cot)

    leaf, leaf_dirs = sh.clone().requires_grad_(), dirs.clone().requires_grad_()

    def autograd():
        with torch.enable_grad():
            colors = sh_ops.eval_sh_torch(degree, leaf, leaf_dirs)
            return torch.autograd.grad(colors, (leaf, leaf_dirs), cot)

    colors, colors_again = fwd_kernel(), fwd_kernel()
    want = sh_ops.eval_sh_torch(degree, sh, dirs)
    err = (colors - want).abs()
    fwd = {
        **shape, "max_abs_err": float(err.max()) if n else 0.0,
        "n_over": int((err > ATOL + RTOL * want.abs()).sum()),
        "bitwise_repeatable": bool(torch.equal(colors, colors_again)),
        "kernel_ms": time_ms(fwd_kernel, reps),
        "kernel_ms_back_to_back": time_back_to_back_ms(fwd_kernel, reps),
        "device_ms": device_ms(fwd_kernel),
        "plain_ms": time_ms(lambda: sh_ops.eval_sh_torch(degree, sh, dirs), reps),
        **roofline.sh_forward_cost(n, degree).fields(),
    }
    (grad_sh, grad_dirs), again = bwd_kernel(), bwd_kernel()
    want_sh, want_dirs = sh_ops.eval_sh_backward_torch(degree, sh, dirs, cot)
    kink = (sh_ops._sh_value(degree, sh, dirs).abs() < SH_KINK).any(dim=-1)
    sh_err, sh_over = grad_errors(grad_sh[~kink], want_sh[~kink])
    dir_err, dir_over = grad_errors(grad_dirs[~kink], want_dirs[~kink])
    bwd = {
        **shape, "max_abs_err": max(sh_err, dir_err), "n_over": sh_over + dir_over,
        "max_abs_err_grad_sh": sh_err, "max_abs_err_grad_dirs": dir_err,
        "kink_rows": int(kink.sum()),
        "unused_zero": not bool(grad_sh[:, sh_ops.num_sh_bases(degree):].any()),
        "bitwise_repeatable": bool(torch.equal(grad_sh, again[0])
                                   and torch.equal(grad_dirs, again[1])),
        "kernel_ms": time_ms(bwd_kernel, reps),
        "kernel_ms_back_to_back": time_back_to_back_ms(bwd_kernel, reps),
        "device_ms": device_ms(bwd_kernel),
        "plain_ms": time_ms(
            lambda: sh_ops.eval_sh_backward_torch(degree, sh, dirs, cot), reps),
        "autograd_ms": time_ms(autograd, reps),
        "autograd_device_ms": device_ms(autograd),
        **roofline.sh_backward_cost(n, k, degree).fields(),
    }
    return {"sh_fwd": fwd, "sh_bwd": bwd}


def _bits(t):
    return t.view(torch.int32) if t.is_floating_point() else t


@torch.no_grad()
def compare_projection(name, n, reps, seed):
    """proj_fwd and proj_bwd vs their plain versions on n random rows (some
    behind the camera, past the frustum clamp, nearly flat, opacities either
    side of alpha_skip): {kernel name: case}. The forward must be bitwise
    the plain forward (`n_over` counts the elements that are not; `rows_off`
    the rows whose radii, valid or quantized extents differ); the backward
    under a train step's cotangents of unit scale. Both run twice (bitwise
    equal). Beside each kernel's times: its plain version's, and for the
    backward autograd's forward and backward through the plain forward (the
    stage the kernels replaced)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    means = 2.5 * torch.randn((n, 3), generator=gen, device=DEVICE)
    means[: n // 10, 2] -= 8.0
    quats = torch.randn((n, 4), generator=gen, device=DEVICE)
    scales = torch.exp(torch.empty((n, 3), device=DEVICE).uniform_(-6.0, -1.0, generator=gen))
    scales[: n // 7, 0] = 1e-5
    opac = torch.rand((n,), generator=gen, device=DEVICE)
    cam = Camera.from_lookat((0.3, 0.5, -5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 60.0,
                             1152, 864, device=DEVICE)
    cfg = RenderConfig()
    settings = proj_ops._Settings(cfg.near_plane, cfg.cov2d_dilation, cfg.sigma_extent,
                                  cfg.alpha_skip)
    kw = dict(near_plane=cfg.near_plane, cov2d_dilation=cfg.cov2d_dilation,
              sigma_extent=cfg.sigma_extent, opacities=opac, alpha_skip=cfg.alpha_skip)
    widths = dict(means2d=2, conics=3, depths=0, dirs=3)
    grads = proj_ops.ProjectionGrads(**{
        k: torch.randn((n, widths[k]) if widths[k] else (n,), generator=gen, device=DEVICE)
        for k in PROJ_TRAIN_COTANGENTS})
    shape = {"case": name, "n_splats": n, "opacity_aware": True}

    def fwd_kernel():
        return proj_ops.projection_forward(means, quats, scales, opac, cam, settings)

    def bwd_kernel():
        return proj_ops.projection_backward(means, quats, scales, opac, cam, settings, grads)

    def plain_fwd():
        return (proj_ops.project_gaussians_torch(means, quats, scales, cam, **kw),
                proj_ops.view_directions(means, cam))

    leaves = [t.clone().requires_grad_() for t in (means, quats, scales, opac)]

    def autograd():
        with torch.enable_grad():
            p = proj_ops.project_gaussians_torch(*leaves[:3], cam, **{**kw, "opacities": leaves[3]})
            dirs = proj_ops.view_directions(leaves[0], cam)
            outs = (p.means2d, p.conics, p.depths, dirs)
            return torch.autograd.grad(outs, leaves[:3], tuple(g for g in grads if g is not None))

    (got, dirs), (again, dirs_again) = fwd_kernel(), fwd_kernel()
    want, want_dirs = plain_fwd()
    pairs = list(zip((*got, dirs), (*want, want_dirs)))
    ext_q = [quantize_extent_up(p.extents) for p in (got, want)]
    rows_off = (got.radii != want.radii) | (got.valid != want.valid) \
        | (ext_q[0] != ext_q[1]).any(-1)
    fwd = {
        **shape,
        "n_over": sum(int((_bits(a) != _bits(b)).sum()) for a, b in pairs),
        "max_abs_err": max(float((a.float() - b.float()).abs().max()) for a, b in pairs),
        "rows_off": int(rows_off.sum()), "valid_rows": int(want.valid.sum()),
        "bitwise_repeatable": all(torch.equal(_bits(a), _bits(b)) for a, b in
                                  zip((*got, dirs), (*again, dirs_again))),
        "kernel_ms": time_ms(fwd_kernel, reps),
        "kernel_ms_back_to_back": time_back_to_back_ms(fwd_kernel, reps),
        "device_ms": device_ms(fwd_kernel),
        "plain_ms": time_ms(plain_fwd, reps),
        **roofline.projection_forward_cost(n, True).fields(),
    }
    back, back_again = bwd_kernel(), bwd_kernel()
    plain_back = proj_ops.project_backward_torch(means, quats, scales, cam, grads, **kw)
    truth = proj_ops.project_backward_torch(
        means.double(), quats.double(), scales.double(), cam,
        proj_ops.ProjectionGrads(*(None if g is None else g.double() for g in grads)),
        **{**kw, "opacities": opac.double()})
    errs = {k: grad_errors_against(g, p, t)
            for k, g, p, t in zip(("means", "quats", "scales"), back, plain_back, truth)}
    bwd = {
        **shape, "cotangents": list(PROJ_TRAIN_COTANGENTS),
        "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
        "n_over": sum(e["n_over"] for e in errs.values()),
        **{f"grad_{k}": e for k, e in errs.items()},
        "nan_rows_equal": all(torch.equal(g.isnan(), w.isnan())
                              for g, w in zip(back[:3], plain_back[:3])),
        "bitwise_repeatable": all(torch.equal(_bits(a), _bits(b))
                                  for a, b in zip(back[:3], back_again[:3])),
        "kernel_ms": time_ms(bwd_kernel, reps),
        "kernel_ms_back_to_back": time_back_to_back_ms(bwd_kernel, reps),
        "device_ms": device_ms(bwd_kernel),
        "plain_ms": time_ms(
            lambda: proj_ops.project_backward_torch(means, quats, scales, cam, grads, **kw), reps),
        "autograd_ms": time_ms(autograd, reps),
        "autograd_device_ms": device_ms(autograd),
        **roofline.projection_backward_cost(n, True, PROJ_TRAIN_COTANGENTS).fields(),
    }
    return {"proj_fwd": fwd, "proj_bwd": bwd}


def kernel_device_ms(fn, names, calls=5):
    """Milliseconds per call of the device time of each kernel in `names`
    that fn() launches (the profiler's, by kernel name), and of everything
    else fn() puts on the device. fn is called once before."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = dict.fromkeys(names, 0.0)
    other = 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.end - e.time_range.start
        name = next((k for k in names if e.name.startswith(k)), None)
        if name is None:
            other += us
        else:
            by_name[name] += us
    return {k: v / 1e3 / calls for k, v in by_name.items()}, other / 1e3 / calls


@torch.no_grad()
def compare_binning(name, proj, opac, width, height, config, reps, **band):
    """binning's kernels (bin_gaussians on CUDA tensors: the depth argsort,
    then the chain) against the plain version on the same card: every field
    bit for bit, two runs bitwise equal; times beside the chain's bound."""
    def kernel():
        return bin_gaussians(proj, width, height, config, opacities=opac, **band)

    def plain():
        return bin_gaussians_torch(proj, width, height, config, opacities=opac, **band)

    def fields(b):
        return {**{f: getattr(b, f) for f in b._fields if f != "kept"},
                **{f"kept.{k}": v for k, v in b.kept._asdict().items()}}

    got, again, want = (fields(f()) for f in (kernel, kernel, plain))
    torch.cuda.synchronize()
    differing = [k for k in want if not (got[k].shape == want[k].shape
                                         and torch.equal(got[k], want[k]))]
    errs = [float((got[k].long() - want[k].long()).abs().max()) for k in differing
            if got[k].shape == want[k].shape and got[k].numel()]
    m, n = got["rank_starts"].numel() - 1, proj.means2d.shape[0]
    emission = binning_ops.emission_rows(m, config)
    chain_ms, other_ms = kernel_device_ms(kernel, binning_ops.KERNELS)
    return {
        "case": name, "n_splats": n, "table_rows": m, "width": width, "height": height,
        "tile_row0": band.get("tile_row0", 0), "tiles": got["tile_counts"].numel(),
        "pairs": int(got["num_pairs"]) - int(got["overflow"]),
        **{k: int(got[k]) for k in ("num_pairs", "overflow", "clamped_rects",
                                    "tier_overflow", "dropped_gaussians")},
        "slots": emission.slots, "budget": got["pair_gauss"].numel(),
        # integers: exact, or wrong
        "fields_differing": differing, "n_over": len(differing),
        "max_abs_err": max(errs, default=0.0),
        "bitwise_repeatable": all(torch.equal(got[k], again[k]) for k in got),
        "kernel_ms": time_ms(kernel, reps),
        "kernel_ms_back_to_back": time_back_to_back_ms(kernel, reps, calls=5),
        "device_ms": device_ms(kernel, calls=5),
        # the four kernels' device time, and the rest (the depth key and
        # argsort, the fills)
        "chain_device_ms": chain_ms, "argsort_and_fills_device_ms": other_ms,
        "plain_ms": time_ms(plain, max(2, reps // 2)),
        "plain_device_ms": device_ms(plain, calls=2),
        **roofline.binning_cost(
            n, m, got["tile_counts"].numel(), got["pair_gauss"].numel(), emission.k_small,
            emission.k_big, emission.big, sigma_test=opac is not None,
            extents=proj.extents is not None).fields(),
    }


def big_k_case(name, rows, width, height, big_headroom, seed):
    """A binning case at the cap calibration gives: `rows` random splats,
    the first TAIL_ROWS with log-uniform TAIL_SCALES, at rubble's camera."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    model = GaussianModel.random(gen, rows, sh_degree=0, extent=1.0,
                                 scale_range=(0.0004, 0.004), device=DEVICE)
    lo, hi = (float(np.log(x)) for x in TAIL_SCALES)
    with torch.no_grad():
        model.log_scales[:TAIL_ROWS] = torch.empty(
            (TAIL_ROWS, 3), device=DEVICE).uniform_(lo, hi, generator=gen)
    cam = Camera.from_lookat((0.0, 1.0, -1.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 55.0,
                             width, height, device=DEVICE)
    cfg = calibrate_render_config(model, cam, RenderConfig(max_tiles_per_gaussian=RUBBLE_K),
                                  big_headroom=big_headroom)
    frame = cfg.num_tiles(width, height)
    check(cfg.max_tiles_per_gaussian == min(frame, binning_ops.MAX_K_BIG),
          f"{name}: calibration gave K {cfg.max_tiles_per_gaussian} for {frame} tiles")
    with torch.no_grad():
        proj, _ = _project_and_shade(model, cam, cfg)
        opac = _effective_opacities(model, proj, cfg)
        uncapped = dataclasses.replace(cfg, max_tiles_per_gaussian=frame)
        _, _, w, h, _ = binning_ops.tile_rects(proj.means2d, proj.radii, proj.valid, width,
                                               height, uncapped, extents=proj.extents)
    case = compare_binning(name, proj, opac, width, height, cfg, reps=5)
    case.update(k_big=cfg.max_tiles_per_gaussian, largest_rect_tiles=int((w * h).max()))
    check(case["largest_rect_tiles"] > RUBBLE_K and case["tier_overflow"] == 0,
          f"{name}: no rect past {RUBBLE_K} tiles, or the tier overflowed: {case}")
    check((case["clamped_rects"] > 0) == (frame > binning_ops.MAX_K_BIG),
          f"{name}: clamped_rects {case['clamped_rects']} with K {case['k_big']}")
    return case


def binning_cases(model, camera, config):
    """binning's cases: the small scenes, the bench frame (its band 2 of 4
    as the sharded path bins it), a random scene of rubble's rows at its
    frame under the cap calibration gives the train mix, and BIG_K_CASES."""
    cases = []
    for name, m, cam, cfg, _ in small_scenes():
        with torch.no_grad():
            proj, _ = _project_and_shade(m, cam, cfg)
            opac = _effective_opacities(m, proj, cfg)
        cases.append(compare_binning(name, proj, opac, cam.width, cam.height, cfg, reps=5))
    with torch.no_grad():
        proj, _ = _project_and_shade(model, camera, config)
        opac = _effective_opacities(model, proj, config)
    cases.append(compare_binning("bench_full", proj, opac, WIDTH, HEIGHT, config, reps=10))
    (proj_b, _, opac_b), band_args, cfg_b, band_h = band_inputs(
        model, camera, config, BANDS, FULL_BAND)
    cases.append(compare_binning(FULL_BAND_CASE, proj_b, opac_b, WIDTH, band_h, cfg_b,
                                 reps=10, **band_args))
    del proj, opac, proj_b, opac_b
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    rubble = GaussianModel.random(gen, RUBBLE_ROWS, sh_degree=0, extent=1.0,
                                  scale_range=(0.0004, 0.004), device=DEVICE)
    cam = Camera.from_lookat((0.0, 1.0, -1.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 55.0,
                             RUBBLE_W, RUBBLE_H, device=DEVICE)
    cfg = calibrate_render_config(rubble, cam, RenderConfig(max_tiles_per_gaussian=RUBBLE_K),
                                  big_headroom=16.0)
    with torch.no_grad():
        proj, _ = _project_and_shade(rubble, cam, cfg)
        opac = _effective_opacities(rubble, proj, cfg)
    cases.append(compare_binning("rubble_rows", proj, opac, RUBBLE_W, RUBBLE_H, cfg, reps=5))
    del rubble, proj, opac
    for i, case in enumerate(BIG_K_CASES):
        cases.append(big_k_case(*case, seed=60 + i))
    return cases


def phase_kernels(model, camera, config):
    """{kernel name: [case, ...]} over the small shapes and the full frame,
    segsum's ragged case at full size, the SH kernels' SH_CASES, the
    projection's PROJ_CASES, and binning's chain ("binning")."""
    scenes = small_scenes()
    runs = [
        compare_kernels(name, m, cam, cfg, reps=5, tamper=tamper)
        for name, m, cam, cfg, tamper in scenes
    ]
    # the band form (tile_row0 > 0): the second of two bands, binned as the
    # sharded path bins it; the third scene's 7 tile rows pad to 8
    by_name = {scene[0]: scene for scene in scenes}
    for name in SMALL_BAND_CASES:
        _, m, cam, cfg, _ = by_name[name]
        runs.append(compare_kernels(f"{name}_band1of2", m, cam, cfg, reps=5, band=(2, 1)))
    runs.append(compare_kernels("bench_full", model, camera, config, reps=10))
    runs.append(compare_kernels(FULL_BAND_CASE, model, camera, config, reps=10,
                                band=(BANDS, FULL_BAND)))
    cases = {k: [run[k] for run in runs] for k in runs[0]}
    cases["segsum"].append(segsum_ragged(reps=10))
    cases["sh_fwd"], cases["sh_bwd"] = [], []
    for i, (name, n, k, degree) in enumerate(SH_CASES):
        for kernel, case in compare_sh(name, n, k, degree, reps=10, seed=20 + i).items():
            cases[kernel].append(case)
    cases["proj_fwd"], cases["proj_bwd"] = [], []
    for i, (name, n) in enumerate(PROJ_CASES):
        for kernel, case in compare_projection(name, n, reps=10, seed=40 + i).items():
            cases[kernel].append(case)
    cases["binning"] = binning_cases(model, camera, config)
    for kernel, kernel_cases in cases.items():
        for c in kernel_cases:
            check(c["n_over"] == 0,
                  f"{kernel} differs from its plain version on {c['case']}: "
                  f"{c['n_over']} elements, max abs err {c['max_abs_err']}")
            check(c.get("bitwise_repeatable", True),
                  f"{kernel}: two runs on {c['case']} are not bitwise equal")
            check(c.get("pad_columns_and_rows_zero", True),
                  f"{kernel}: padding rows or columns not zero on {c['case']}")
            check(c.get("equals_rank_sort", True) and c.get("perm_equals_rank_sort", True),
                  f"{kernel}: the permutation from binning is not the rank sort's "
                  f"on {c['case']}")
            check(c.get("empty_ranks_zero", True),
                  f"{kernel}: an empty rank's sum is not zero on {c['case']}")
            check(c.get("owned_once", True),
                  f"{kernel}: a rank without exactly one owning warp on {c['case']}")
            check(c.get("unused_zero", True),
                  f"{kernel}: the unused coefficients' gradient is not zero on {c['case']}")
            check(c.get("kink_rows", 0) <= c["n_splats"] // 1000 + 1,
                  f"{kernel}: {c.get('kink_rows')} rows at the clamp's kink on {c['case']}")
            check(c.get("rows_off", 0) == 0 and c.get("nan_rows_equal", True),
                  f"{kernel}: rows whose radii, valid, extents or NaNs differ on {c['case']}")
    return cases


def seeded_loss(out, gen_seed):
    """A fixed scalar of image, depth and alpha with unit-scale weights."""
    gen = torch.Generator(device=DEVICE).manual_seed(gen_seed)
    h, w, _ = out.image.shape
    wi = torch.randn((h, w, 3), generator=gen, device=DEVICE)
    wd = torch.randn((h, w), generator=gen, device=DEVICE)
    wa = torch.randn((h, w), generator=gen, device=DEVICE)
    return (out.image * wi).sum() + (out.depth * wd).sum() + (out.alpha * wa).sum()


def phase_golden_grad():
    """The slice's gradient on the golden scene: kernels vs autograd through
    the plain compositor, both on the card."""
    model = load_gaussians(os.path.join(ROOT, "tests", "golden", "scene.ply"), device=DEVICE)
    cam = Camera.from_lookat(
        (0.0, 1.2, -2.6), (0, 0, 0), (0, 1, 0), 50.0, 160, 120, device=DEVICE
    )
    grads = {}
    for run, backend in (("cuda", "cuda"), ("cuda_again", "cuda"), ("torch_tile", "torch_tile")):
        cfg = RenderConfig(backend=backend, background=(0.05, 0.05, 0.08))
        model.zero_grad(set_to_none=True)
        seeded_loss(render(model, cam, cfg), 11).backward()
        grads[run] = {k: getattr(model, k).grad.clone() for k in model.LEAVES}
    repeatable = all(torch.equal(grads["cuda"][k], grads["cuda_again"][k]) for k in model.LEAVES)
    check(repeatable, "golden_grad: two backward runs through the kernels differ")
    report = {}
    for k in model.LEAVES:
        got, want = grads["cuda"][k], grads["torch_tile"][k]
        got, want = (x.reshape(x.shape[0], -1) for x in (got, want))
        # The golden scene's splats are isotropic: rotating one changes
        # nothing, so d quats is zero in exact arithmetic and both sides hold
        # the rounding of terms as large as d log_scales (both come from the
        # covariance's gradient). Judge it at that magnitude.
        floor = float(grads["torch_tile"]["log_scales"].abs().max()) if k == "quats" else 0.0
        err, over = grad_errors(got, want, floor)
        report[k] = {"max_abs_err": err, "n_over": over, "max_abs": float(want.abs().max())}
        check(bool(torch.isfinite(got).all()) and over == 0,
              f"golden_grad: d{k} differs from autograd: {report[k]}")
    emit("golden_grad", rtol=GRAD_RTOL, atol_rel=GRAD_ATOL_REL, grads=report,
         bitwise_repeatable=repeatable)


def phase_no_fallback():
    """On CUDA tensors a training step whose kernel cannot be built raises,
    whichever library of csrc/ it is; nothing gives way to a plain version
    or to autograd through one."""
    _, model, cam, cfg, _ = small_scenes()[0]
    cuda_raster.reset_launch_counts()
    render(model, cam, cfg).image.sum().backward()
    step_launches = dict(cuda_raster.launch_counts)
    real = _build.load_library
    raised, binning_launches = {}, {}
    for broken in _build.kernel_names():
        def load(name, broken=broken):
            if name == broken:
                raise _build.KernelCompileError(f"build of {name} made to fail")
            return real(name)

        _build.load_library = load
        cuda_raster.reset_launch_counts()
        try:
            try:
                render(model, cam, cfg).image.sum().backward()
                raised[broken] = False
            except _build.KernelCompileError:
                raised[broken] = True
        finally:
            _build.load_library = real
        binning_launches[broken] = {k: cuda_raster.launch_counts[k] for k in binning_ops.KERNELS}
    emit("no_fallback", raised_on_failed_build=raised, step_launches=step_launches,
         binning_launches_when_broken=binning_launches)
    check(all(raised.values()),
          f"a training step survived a failed kernel build: {raised}")
    check(step_launches == dict.fromkeys(cuda_raster.KERNELS, 1),
          f"a training step launched a kernel other than once: {step_launches}")
    check(not any(binning_launches["binning"].values()),
          f"a binning kernel launched without its library: {binning_launches}")


def phase_main_path(model, camera, smi):
    """Viewer frames at full size: orbit poses plus the bench pose."""
    orbit = [
        orbit_camera(5.0, 360.0 * i / ORBIT_FRAMES, 20.0, width=WIDTH, height=HEIGHT,
                     device=DEVICE)
        for i in range(ORBIT_FRAMES)
    ]
    config = calibrate_render_config(model, [camera, *orbit], RenderConfig())
    viewer = Viewer(model, config, width=WIDTH, height=HEIGHT, show_overlay=False,
                    device=DEVICE)
    viewer.render_frame(camera)  # warm-up: loads the library, fills the allocator
    torch.cuda.synchronize()
    viewer.timers.stats.clear()

    frames, stats, wall_ms = [], [], []
    cuda_raster.reset_launch_counts()

    def one(cam):
        t0 = time.perf_counter()
        frames.append(viewer.render_frame(cam))
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        out = viewer.last_output
        check(bool(torch.isfinite(out.image).all() and torch.isfinite(out.alpha).all()),
              "frame not finite")
        stats.append({k: int(v) for k, v in out.stats._asdict().items()})
        return out

    # the user's entry points: a turntable, then single frames
    viewer.orbit_turntable(n_frames=ORBIT_FRAMES, radius=5.0, elevation_deg=20.0)
    turntable_launches = cuda_raster.launch_counts["raster_fwd"]
    for cam in [*orbit, camera]:
        last = one(cam)
    all_launches = dict(cuda_raster.launch_counts)
    launches = all_launches["raster_fwd"]
    n_frames = 2 * ORBIT_FRAMES + 1

    alpha_mean = float(last.alpha.mean())
    for f in frames:
        check(f.dtype == np.uint8 and f.shape == (HEIGHT, WIDTH, 3), "frame shape/dtype")
    check(alpha_mean > 0.05, f"bench frame almost empty: alpha mean {alpha_mean}")
    check(all(s["overflow"] == 0 and s["tier_overflow"] == 0 for s in stats),
          f"binning sentinels fired: {stats}")
    check(turntable_launches == ORBIT_FRAMES and launches == n_frames,
          f"expected one raster_fwd launch per frame: {launches} launches, "
          f"{n_frames} frames")
    check(all(all_launches[k] == 0
              for k in ("raster_bwd", "rank_perm", "segsum", "sh_bwd", "proj_bwd")),
          f"serving frames launched a backward kernel: {all_launches}")
    once = ("sh_fwd", "proj_fwd", *binning_ops.KERNELS)
    check(all(all_launches[k] == n_frames for k in once),
          f"expected one launch of each of {once} per frame: {all_launches}, "
          f"{n_frames} frames")

    # where a frame's time goes, stage by stage, at the bench pose
    cfg = viewer._render_config
    (proj, colors, opac), binning, args = raster_inputs(model, camera, cfg)
    with torch.no_grad():
        split = {
            "project_sh_ms": time_ms(lambda: _project_and_shade(model, camera, cfg), 5),
            "binning_ms": time_ms(
                lambda: bin_gaussians(proj, WIDTH, HEIGHT, cfg, opacities=opac), 5),
            "table_gather_ms": time_ms(
                lambda: tile_raster.build_splat_table(proj, colors, opac, binning.order, cfg), 5),
            "raster_ms": time_ms(
                lambda: cuda_raster.raster_forward(*args, WIDTH, HEIGHT, cfg), 5),
        }
    frame_stat = viewer.timers.stats["frame"]
    emit(
        "main_path", gpu=smi, n_splats=model.num_gaussians, width=WIDTH, height=HEIGHT,
        frames=n_frames, launches=launches, launches_per_frame=launches / n_frames,
        frame_ms=frame_stat.median, frame_ms_min=frame_stat.min,
        frame_ms_bench_pose=frame_stat.last,
        frame_wall_ms=statistics.median(wall_ms),
        num_pairs=[s["num_pairs"] for s in stats][-1], num_pairs_min=min(s["num_pairs"] for s in stats),
        num_pairs_max=max(s["num_pairs"] for s in stats),
        overflow=0, tier_overflow=0, clamped_rects=stats[-1]["clamped_rects"],
        alpha_mean=alpha_mean, pairs_per_gaussian=config.pairs_per_gaussian,
        big_tier_capacity=config.big_tier_capacity, split_ms=split,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 2**30,
    )
    return all_launches


def perturbed(model, seed, scale=0.01):
    """A seeded perturbation of the model: what the training target shows."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    other = GaussianModel.create(
        *(getattr(model, k).detach() for k in model.LEAVES), device=DEVICE
    )
    with torch.no_grad():
        other.means += scale * torch.randn(other.means.shape, generator=gen, device=DEVICE)
        other.sh += 0.2 * torch.randn(other.sh.shape, generator=gen, device=DEVICE)
    return other


def step_split(model, camera, target, cfg, tc):
    """Where a train step's time goes: each stage timed on its own by CUDA
    events, on the inputs the step gives it (on a copy of the model: the
    Adam stage really updates it)."""
    model = copy.deepcopy(model)
    optimizer = trainer.make_optimizer(model, tc)
    proj, colors = _project_and_shade(model, camera, cfg)
    opac = _effective_opacities(model, proj, cfg)
    binning = bin_gaussians(proj, WIDTH, HEIGHT, cfg, opacities=opac)
    table = tile_raster.build_splat_table(proj, colors, opac, binning.order, cfg)
    args = (table.detach(), binning.pair_gauss, binning.tile_offsets, binning.tile_counts)
    walked = torch.zeros_like(binning.tile_counts)
    rgbd, t_final = cuda_raster.raster_forward(*args, WIDTH, HEIGHT, cfg, walked=walked)
    n = model.num_gaussians

    image = rgbd[..., :3].clone().requires_grad_()
    photometric_loss(image, target, tc.ssim_weight).backward()
    d_rgbd = torch.cat([image.grad, torch.zeros_like(rgbd[..., 3:])], dim=-1)
    d_t = torch.zeros_like(t_final)
    bwd_args = (*args, rgbd, t_final, d_rgbd, d_t, WIDTH, HEIGHT, cfg)
    rows = cuda_raster.raster_backward(*bwd_args, walked=walked)

    def build_perm():
        return cuda_raster.rank_permutation_from_sort(
            binning.pair_src, binning.rank_starts, binning.kept, cfg)

    perm = build_perm()
    check(torch.equal(perm, tile_raster.rank_permutation(
        binning.pair_gauss, binning.rank_starts, n)),
        "step_split: the permutation from binning is not the rank sort's")
    check(torch.equal(perm, build_perm()), "step_split: rank_perm differs from run to run")
    d_table = cuda_raster.segment_sum(rows, perm, binning.rank_starts, n)
    params = [getattr(model, k) for k in model.LEAVES]

    def loss_fwd_bwd():
        x = rgbd[..., :3].clone().requires_grad_()
        photometric_loss(x, target, tc.ssim_weight).backward()

    def autograd_rest():
        grads = torch.autograd.grad(table, params, d_table, retain_graph=True)
        for prm, g in zip(params, grads):
            prm.grad = g

    split = {
        "project_sh_ms": time_ms(lambda: _project_and_shade(model, camera, cfg), 5),
        "binning_ms": time_ms(
            lambda: bin_gaussians(proj, WIDTH, HEIGHT, cfg, opacities=opac), 5),
        "table_gather_ms": time_ms(
            lambda: tile_raster.build_splat_table(proj, colors, opac, binning.order, cfg), 5),
        "raster_fwd_ms": time_ms(
            lambda: cuda_raster.raster_forward(*args, WIDTH, HEIGHT, cfg, walked=walked), 5),
        "loss_fwd_bwd_ms": time_ms(loss_fwd_bwd, 5),
        "raster_bwd_ms": time_ms(
            lambda: cuda_raster.raster_backward(*bwd_args, walked=walked), 5),
        "perm_ms": time_ms(build_perm, 5),
        "segsum_ms": time_ms(
            lambda: cuda_raster.segment_sum(rows, perm, binning.rank_starts, n), 5),
        "autograd_projection_sh_ms": time_ms(autograd_rest, 5),
        "adam_ms": time_ms(optimizer.step, 5),
    }
    model.zero_grad(set_to_none=True)
    return split


def phase_train_path(model, camera, smi, workdir):
    """The training path at full width: `fit` on one view, then
    `fit_multiview_adc` on four with a densify, a checkpoint and a resume."""
    truth = perturbed(model, seed=3)
    views = [
        orbit_camera(5.0, 360.0 * i / ADC_VIEWS, 20.0, fov_y_deg=50.0, width=WIDTH,
                     height=HEIGHT, device=DEVICE)
        for i in range(ADC_VIEWS)
    ]
    # capacities over every training camera, with more headroom than a viewer
    # takes: the splats move and are respawned while the run lasts
    cfg = calibrate_render_config(
        model, [camera, *views], RenderConfig(), pair_headroom=1.3, big_headroom=1.5
    )
    with torch.no_grad():
        target = render(truth, camera, cfg).image
    dataset = orbit_dataset(
        lambda cam: render(truth, cam, cfg).image, n_views=ADC_VIEWS, radius=5.0,
        elevation_deg=20.0, width=WIDTH, height=HEIGHT, fov_y_deg=50.0, device=DEVICE,
    )
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # (a) fit: one view, through make_train_step
    tc = TrainConfig(num_steps=FIT_STEPS)
    step_ms, sentinels = [], []
    state = {"t": None}

    def on_step(i, loss, train_state):
        torch.cuda.synchronize()
        now = time.perf_counter()
        if state["t"] is not None:
            step_ms.append((now - state["t"]) * 1e3)
        state["t"] = now

    cuda_raster.reset_launch_counts()
    fitted, history = fit(model, camera, target, cfg, tc, log_every=1, callback=on_step)
    fit_launches = dict(cuda_raster.launch_counts)
    with torch.no_grad():
        out = render(fitted, camera, cfg)
    sentinels.append({k: int(v) for k, v in out.stats._asdict().items()})
    check(len(history) == FIT_STEPS and all(np.isfinite(history)),
          f"fit: losses {history}")
    check(history[-1] < history[0], f"fit: the loss did not fall: {history}")
    check(all(v == FIT_STEPS for v in fit_launches.values()),
          f"fit: expected one launch of each kernel per step: {fit_launches}")
    check(not any(torch.equal(getattr(fitted, k), getattr(model, k)) for k in model.LEAVES),
          "fit: a parameter group did not move")

    # (b) fit_multiview_adc: four views, densify at steps 2 and 4, checkpoints
    # at steps 3 and 6, then a resume that runs two steps more
    ck = os.path.join(workdir, "checkpoints")
    adc_kw = dict(densify_every=2, opacity_reset_every=0, victim_fraction=0.01, log_every=1)
    cuda_raster.reset_launch_counts()
    tc_first = TrainConfig(num_steps=ADC_STEPS, checkpoint_dir=ck, checkpoint_every=3)
    _, h1 = fit_multiview_adc(model, dataset, cfg, tc_first, **adc_kw)
    saved_at = latest_step(ck)
    tc_more = TrainConfig(num_steps=ADC_RESUME_STEPS, checkpoint_dir=ck, checkpoint_every=3)
    adc_model, h2 = fit_multiview_adc(model, dataset, cfg, tc_more, resume=True, **adc_kw)
    adc_launches = dict(cuda_raster.launch_counts)
    with torch.no_grad():
        for i in range(ADC_VIEWS):
            out = render(adc_model, dataset.camera(i), cfg)
            sentinels.append({k: int(v) for k, v in out.stats._asdict().items()})
    check(len(h1) == ADC_STEPS and all(np.isfinite(h1 + h2)), f"adc: losses {h1} {h2}")
    check(saved_at == ADC_STEPS, f"adc: latest checkpoint at step {saved_at}")
    check(len(h2) == ADC_RESUME_STEPS - ADC_STEPS,
          f"adc: the resumed run took {len(h2)} steps, not {ADC_RESUME_STEPS - ADC_STEPS}")
    check(all(v == ADC_RESUME_STEPS for v in adc_launches.values()),
          f"adc: expected one launch of each kernel per step: {adc_launches}")
    check(all(s["overflow"] == 0 and s["tier_overflow"] == 0 for s in sentinels),
          f"binning sentinels fired after training: {sentinels}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    split = step_split(model, camera, target, cfg, tc)
    steps = FIT_STEPS + ADC_RESUME_STEPS
    launches = {k: fit_launches[k] + adc_launches[k] for k in cuda_raster.KERNELS}
    emit(
        "train_path", gpu=smi, n_splats=model.num_gaussians, width=WIDTH, height=HEIGHT,
        steps=steps, launches=launches,
        launches_per_step={k: v / steps for k, v in launches.items()},
        step_ms=statistics.median(step_ms), step_ms_min=min(step_ms),
        step_ms_all=step_ms, fit_losses=history, adc_losses=h1, adc_resumed_losses=h2,
        checkpoint_step=saved_at, densify_steps=[2, 4, 6],
        num_pairs=sentinels[0]["num_pairs"], overflow=0, tier_overflow=0,
        pairs_per_gaussian=cfg.pairs_per_gaussian,
        big_tier_capacity=cfg.big_tier_capacity, split_ms=split,
        split_sum_ms=sum(split.values()), peak_memory_gb=peak_gb,
    )
    return launches


def psnr(a, b):
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0.0 else 10.0 * np.log10(255.0 ** 2 / mse)


def decode_jpeg(body):
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_get(url):
    """(status, content type, body, round-trip ms), with a socket timeout."""
    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=HTTP_TIMEOUT) as r:
        body = r.read()
        return r.status, r.headers.get("Content-Type"), body, (time.perf_counter() - t0) * 1e3


def launches_since(before):
    return {k: cuda_raster.launch_counts[k] - before[k] for k in cuda_raster.KERNELS}


DRAG = [(1010, 560), (1060, 575), (1110, 585)]  # the served drag's moves, after a
#   press at the frame's centre


def view_cameras():
    """Every camera the served frames take: the trackball's start pose, its
    poses along the drag, and the last one at 1280x720."""
    tb = TrackballCamera()
    cams = [tb.camera(WIDTH, HEIGHT, DEVICE)]
    tb.handle_mouse_down(WIDTH // 2, HEIGHT // 2, 0)
    for x, y in DRAG:
        tb.handle_mouse_move(x, y, HEIGHT)
        cams.append(tb.camera(WIDTH, HEIGHT, DEVICE))
    tb.handle_mouse_up()
    return [*cams, tb.camera(1280, 720, DEVICE)]


def device_busy(prof):
    """(busy ms, events) of the device in a profiler window: the union of
    the intervals of its events (kernels, copies, fills)."""
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3, len(spans)


def view_load(model, workdir):
    """The bench scene written to a PLY and loaded back by the native reader;
    both readers timed, their arrays bitwise equal."""
    path = os.path.join(workdir, "bench_scene.ply")
    t0 = time.perf_counter()
    save_gaussians(path, model)
    write_ms = (time.perf_counter() - t0) * 1e3
    times = {"native": [], "numpy": []}
    fields = {}
    for use_native in (True, False, True, False):
        t0 = time.perf_counter()
        fields[use_native] = ply.read_ply(path, use_native=use_native)
        times[ply.last_read_path].append((time.perf_counter() - t0) * 1e3)
    check(len(times["native"]) == 2, f"read_ply did not take the native path: {times}")
    check(list(fields[True]) == list(fields[False]) and all(
        fields[True][k].tobytes() == fields[False][k].tobytes() for k in fields[True]),
        "native and numpy read_ply differ")
    t0 = time.perf_counter()
    loaded = load_gaussians(path, device=DEVICE)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    check(ply.last_read_path == "native", "load_gaussians did not read natively")
    check(all(torch.equal(getattr(loaded, k), getattr(model, k)) for k in model.LEAVES),
          "the scene did not survive the PLY round trip")
    return loaded, path, {
        "ply_bytes": os.path.getsize(path), "write_ms": write_ms,
        "read_native_ms": min(times["native"]), "read_numpy_ms": min(times["numpy"]),
        "read_ms_all": times, "load_gaussians_ms": load_ms,
    }


def covering_config(base, scenes):
    """One config whose capacities cover every (model, cameras) in `scenes`:
    the largest `pairs_per_gaussian` and `big_tier_capacity` that
    calibrate_render_config measures for each. A drag subset needs its own:
    the pair budget is `pairs_per_gaussian` × N of the model rendered, and a
    subset keeps the splats that cost more pairs than the average one."""
    cfgs = [calibrate_render_config(m, cams, base) for m, cams in scenes]
    return dataclasses.replace(
        base, pairs_per_gaussian=max(c.pairs_per_gaussian for c in cfgs),
        big_tier_capacity=max(c.big_tier_capacity for c in cfgs))


@torch.no_grad()
def view_subsets(model, cams, camera):
    """The drag subsets at the start pose `cams[0]`: the viewer's
    (impact-valued) and one valued by measure_splat_contributions. Returns
    the config that covers the full model and both subsets on every served
    camera, and the report: each subset within its pair budget, each frame
    lighter than the full one."""
    cam0 = cams[0]
    config = calibrate_render_config(model, [camera, *cams], RenderConfig())
    costs = measure_pair_costs(model, cam0, config, device=DEVICE)
    before = dict(cuda_raster.launch_counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    values = measure_splat_contributions(model, cam0, config, device=DEVICE)
    contrib_ms = (time.perf_counter() - t0) * 1e3
    contrib_launches = launches_since(before)
    # only the opacities take a gradient: no SH backward, and no projection
    # backward (the extents, the only projected output they reach, steer
    # binning and take no gradient)
    check(contrib_launches == {**dict.fromkeys(cuda_raster.KERNELS, 1), "sh_bwd": 0,
                               "proj_bwd": 0},
          f"measure_splat_contributions: expected one launch of each kernel: {contrib_launches}")
    check(bool(np.isfinite(values).all()) and values.max() > 0, "contributions not finite")
    check(all(getattr(model, k).grad is None for k in model.LEAVES),
          "measure_splat_contributions left a .grad on the model")
    subsets = {"impact": model.lod_pair_budget(LOD_PAIRS, costs),
               "measured": model.lod_pair_budget(LOD_PAIRS, costs, values=values)}
    config = covering_config(config, [(model, [camera, *cams]), (subsets["impact"], cams),
                                      (subsets["measured"], [cam0])])
    budget = LOD_PAIRS * float(np.maximum(costs, 1).sum())
    full = render(model, cam0, config)
    full_pairs = int(full.stats.num_pairs)
    report = {"full_num_pairs": full_pairs, "budget": budget, "contributions_ms": contrib_ms,
              "contributions_launches": contrib_launches}
    for name, sub in subsets.items():
        cost = int(measure_pair_costs(sub, cam0, config, device=DEVICE).sum())
        out = render(sub, cam0, config)
        st = {k: int(v) for k, v in out.stats._asdict().items()}
        check(cost <= budget + 1e-6, f"{name} subset costs {cost} pairs, budget {budget}")
        check(st["num_pairs"] < full_pairs and st["overflow"] == 0 and st["tier_overflow"] == 0,
              f"{name} subset frame: {st}, the full frame {full_pairs} pairs")
        report[name] = {"n_splats": sub.num_gaussians, "pair_cost": cost,
                        "num_pairs": st["num_pairs"]}
    return config, subsets["impact"], report


def view_serve(viewer):
    """serve() driven over HTTP: full frames, a drag (LoD frames), metrics,
    modes, the overlay toggle and a resize; one raster_fwd launch a frame."""
    from gaussian_splat_tpu_torch.viewer.viewer import INTERACTION_HOLD_S

    port = free_port()
    base = f"http://127.0.0.1:{port}"
    server = viewer.serve(host="127.0.0.1", port=port, block=False)
    served, frames = [], 0
    before = dict(cuda_raster.launch_counts)
    timers = viewer.timers.stats

    def frame(shape, lod):
        nonlocal frames
        n_overlay = len(timers["overlay"]) if "overlay" in timers else 0
        status, ctype, body, ms = http_get(base + "/frame")
        frames += 1
        img = decode_jpeg(body)
        st = {k: int(v) for k, v in viewer.last_stats._asdict().items()}
        check(status == 200 and ctype == "image/jpeg" and img.shape == shape,
              f"/frame: {status} {ctype} {img.shape}, expected {shape}")
        check(viewer.last_frame_lod == lod, f"/frame drew the LoD subset: "
              f"{viewer.last_frame_lod}, expected {lod}")
        check(st["overflow"] == 0 and st["tier_overflow"] == 0, f"sentinels fired: {st}")
        drew_overlay = "overlay" in timers and len(timers["overlay"]) > n_overlay
        served.append({
            "mode": viewer.mode, "lod": lod, "shape": list(shape), "num_pairs": st["num_pairs"],
            "http_ms": ms, "frame_ms": timers["frame"].last, "jpeg_ms": timers["jpeg"].last,
            "overlay_ms": timers["overlay"].last if drew_overlay else None,
            "jpeg_bytes": len(body),
        })
        return img, body

    full_shape = (HEIGHT, WIDTH, 3)
    try:
        status, ctype, body, _ = http_get(base + "/")
        check(status == 200 and ctype == "text/html" and b"/frame" in body, "GET / failed")
        for _ in range(FULL_FRAMES):  # the first fills the allocator, the overlay's grids
            img, body = frame(full_shape, False)
        direct = viewer.render_frame()  # the same pose, through the entry point
        frames += 1
        jpeg_psnr = psnr(img, direct)
        check(jpeg_psnr > JPEG_PSNR_MIN,
              f"served frame vs render_frame: PSNR {jpeg_psnr} dB <= {JPEG_PSNR_MIN}")
        same_bytes = encode_jpeg(direct) == body

        http_get(base + f"/input?kind=down&x={WIDTH // 2}&y={HEIGHT // 2}&b=0")
        for x, y in DRAG:
            http_get(base + f"/input?kind=move&x={x}&y={y}")
            frame(full_shape, True)
        http_get(base + "/input?kind=up")
        metrics = json.loads(http_get(base + "/metrics")[2])
        check(metrics["num_gaussians"] == viewer.model.num_gaussians
              and metrics["resolution"] == [WIDTH, HEIGHT], f"/metrics: {metrics}")
        time.sleep(INTERACTION_HOLD_S)  # idle again: full frames
        for query in ("kind=mode&m=depth", "kind=mode&m=alpha", "kind=mode&m=color"):
            check(http_get(base + "/input?" + query)[0] == 204, f"/input?{query}")
            if not query.endswith("color"):
                frame(full_shape, False)
        http_get(base + "/input?kind=overlay")
        frame(full_shape, False)
        http_get(base + "/input?kind=overlay")
        http_get(base + "/input?kind=resize&w=1280&h=720")
        frame((720, 1280, 3), False)
    finally:
        server.shutdown()
        server.server_close()
    launches = launches_since(before)
    check(launches == {**dict.fromkeys(cuda_raster.KERNELS, 0), "raster_fwd": frames,
                       "sh_fwd": frames, "proj_fwd": frames,
                       **dict.fromkeys(binning_ops.KERNELS, frames)},
          f"expected one launch of each forward kernel per frame ({frames}) and no "
          f"backward: {launches}")

    full = [f for f in served[1:] if f["mode"] == "color" and not f["lod"]
            and f["overlay_ms"] is not None and f["shape"] == list(full_shape)]
    lod = [f for f in served if f["lod"]]
    med = statistics.median
    return {
        "frames": frames, "launches": launches, "jpeg_psnr_db": jpeg_psnr,
        "jpeg_psnr_min_db": JPEG_PSNR_MIN, "jpeg_bytes_equal_direct": same_bytes,
        "frame_ms_full": med(f["frame_ms"] for f in full),
        "frame_ms_lod": med(f["frame_ms"] for f in lod),
        "num_pairs_full": full[-1]["num_pairs"], "num_pairs_lod": [f["num_pairs"] for f in lod],
        "overlay_ms": med(f["overlay_ms"] for f in served[1:] if f["overlay_ms"] is not None),
        "http_frame_ms_full": med(f["http_ms"] for f in full),
        "http_frame_ms_lod": med(f["http_ms"] for f in lod),
        "jpeg_ms": med(f["jpeg_ms"] for f in served[1:]),
        "jpeg_share_of_http_full": med(f["jpeg_ms"] / f["http_ms"] for f in full),
        "metrics": metrics, "served": served,
    }


def view_hot_reload(model, camera, config, workdir):
    """A Viewer with hot_reload watching a copy of csrc/: a comment rebuilds
    raster_fwd under a new hash and the frame stays bitwise the same; a
    syntax error is refused and the last good build keeps serving. The
    plain forward is made to raise meanwhile: it must never run."""
    src = os.path.join(workdir, "csrc_copy")
    shutil.copytree(_build.CSRC_DIR, src)
    kernel = os.path.join(src, "raster_fwd.cu")

    def edit(text):
        with open(kernel, "a") as f:
            f.write(text)
        later = time.time() + 2.0
        os.utime(kernel, (later, later))

    def plain_forbidden(*args, **kwargs):
        raise RuntimeError("the hot-reloading viewer reached raster_forward_torch")

    real_plain = tile_raster.raster_forward_torch
    tile_raster.raster_forward_torch = plain_forbidden
    before = dict(cuda_raster.launch_counts)
    try:
        viewer = Viewer(model, config, width=WIDTH, height=HEIGHT, show_overlay=False,
                        hot_reload=src, device=DEVICE)
        reloader = viewer._reloader
        first = reloader.libraries["raster_fwd"]._name
        f0 = viewer.render_frame(camera)
        edit("\n// an edit that changes no code\n")
        t0 = time.perf_counter()
        f1 = viewer.render_frame(camera)
        reload_ms = (time.perf_counter() - t0) * 1e3
        rebuilt = _build._libs["raster_fwd"]._name
        check(reloader.reloads == 1 and reloader.failures == 0 and rebuilt != first
              and rebuilt == str(_build.library_path("raster_fwd", src)),
              f"raster_fwd was not rebuilt under its new hash: {first} -> {rebuilt}")
        check(np.array_equal(f0, f1), "the rebuilt raster_fwd drew another frame")
        edit("\nthis line is not C++;\n")
        t0 = time.perf_counter()
        f2 = viewer.render_frame(camera)
        refuse_ms = (time.perf_counter() - t0) * 1e3
        check(reloader.failures == 1 and "nvcc failed" in reloader.last_error
              and _build._libs["raster_fwd"]._name == rebuilt,
              "a broken source was not refused, or replaced the last good build")
        check(np.array_equal(f0, f2), "after a refused rebuild the frame changed")
        f3 = viewer.render_frame(camera)  # no change since: no new build
        check(np.array_equal(f0, f3) and reloader.failures == 1, "a frame after the refusal")
        launches = launches_since(before)
        # four frames and two probe frames (the first build's, the rebuild's)
        check(launches == {**dict.fromkeys(cuda_raster.KERNELS, 0), "raster_fwd": 6,
                           "sh_fwd": 6, "proj_fwd": 6, **dict.fromkeys(binning_ops.KERNELS, 6)},
              f"hot reload: launches {launches}")
    finally:
        tile_raster.raster_forward_torch = real_plain
        _build.install(_build.build_libraries())  # the checkout's own libraries again
    return {
        "first_library": os.path.basename(first), "rebuilt_library": os.path.basename(rebuilt),
        "reload_frame_ms": reload_ms, "refused_frame_ms": refuse_ms,
        "refusal": reloader.last_error.strip().splitlines()[-1][:300],
        "frames_bitwise_equal": True, "launches": launches,
    }


def view_trace(viewer, camera, workdir):
    """One bench-pose frame under utils.timing.trace: the device's busy share
    of the frame's host window."""
    viewer.resize(WIDTH, HEIGHT)
    viewer.render_frame(camera)
    torch.cuda.synchronize()
    with trace(os.path.join(workdir, "trace")) as prof:
        t0 = time.perf_counter()
        viewer.render_frame(camera)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, events = device_busy(prof)
    check(events > 0, "the profiler saw no device activity in the traced frame")

    def device_us(e):
        return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)

    top = sorted(prof.key_averages(), key=device_us, reverse=True)[:8]
    return {
        "window_ms": window_ms, "device_busy_ms": busy_ms, "device_events": events,
        "device_busy_share": busy_ms / window_ms,
        "top_device_ms": {e.key[:60]: device_us(e) / 1e3 for e in top},
    }


def phase_view_path(model, camera, smi, workdir):
    """The interactive viewer at full width; returns its launches and the
    PLY it wrote."""
    t_start = time.perf_counter()
    cuda_raster.reset_launch_counts()
    loaded, path, load = view_load(model, workdir)
    cams = view_cameras()
    config, impact, subsets = view_subsets(loaded, cams, camera)
    viewer = Viewer(loaded, config, width=WIDTH, height=HEIGHT, lod_pair_budget=LOD_PAIRS,
                    device=DEVICE)
    check(torch.equal(viewer._model_lod.means, impact.means),
          "the viewer's drag subset is not lod_pair_budget's at the start pose")
    serve = view_serve(viewer)
    hot = view_hot_reload(loaded, camera, config, workdir)
    traced = view_trace(viewer, camera, workdir)
    launches = dict(cuda_raster.launch_counts)
    emit("view_path", gpu=smi, n_splats=loaded.num_gaussians, width=WIDTH, height=HEIGHT,
         lod_pair_budget=LOD_PAIRS, launches=launches, load=load, subsets=subsets,
         serve=serve, hot_reload=hot, trace=traced,
         pairs_per_gaussian=config.pairs_per_gaussian,
         big_tier_capacity=config.big_tier_capacity,
         seconds=time.perf_counter() - t_start)
    return launches, path


def cli_view(ply_path, workdir):
    """`cli view` as a user starts it: wait for its serving line, fetch a
    frame and the metrics, then terminate it."""
    port = free_port()
    cmd = [sys.executable, "-m", "gaussian_splat_tpu_torch.cli", "view", ply_path,
           "--port", str(port), "--width", str(WIDTH), "--height", str(HEIGHT),
           "--lod-pairs", str(LOD_PAIRS)]
    err_path = os.path.join(workdir, "cli_view.err")
    t0 = time.perf_counter()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=err, text=True,
                                env={**os.environ, "PYTHONUNBUFFERED": "1"})
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True).start()
    try:
        try:
            line = lines.get(timeout=HTTP_TIMEOUT)
        except queue.Empty:
            line = ""
        startup_s = time.perf_counter() - t0
        check("serving" in line, f"cli view printed no serving line: {line!r} "
              f"{open(err_path).read()[-2000:]}")
        base = f"http://127.0.0.1:{port}"
        _, ctype, body, frame_ms = http_get(base + "/frame")
        shape = decode_jpeg(body).shape
        metrics = json.loads(http_get(base + "/metrics")[2])
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)
    emit("cli", command="view", serving_line=line.strip(), startup_s=startup_s,
         first_http_frame_ms=frame_ms, frame_shape=list(shape), metrics=metrics,
         returncode=proc.returncode)
    check(ctype == "image/jpeg" and shape == (HEIGHT, WIDTH, 3), f"cli view /frame: {shape}")
    check(metrics["num_gaussians"] == N_SPLATS, f"cli view /metrics: {metrics}")


def phase_cli(workdir, ply_path):
    def run(*argv):
        cmd = [sys.executable, "-m", "gaussian_splat_tpu_torch.cli", *argv]
        return subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)

    scene = os.path.join("tests", "golden", "scene.ply")
    png = os.path.join(workdir, "cli_render.png")
    res = run("render", scene, "--out", png, "--width", "160", "--height", "120",
              "--radius", "3.0")
    size = os.path.getsize(png) if os.path.exists(png) else 0
    emit("cli", command="render", returncode=res.returncode, png_bytes=size,
         stdout=res.stdout.strip())
    check(res.returncode == 0 and size > 0, f"cli render failed: {res.stderr[-2000:]}")

    # train the scene towards the frame just rendered, seen from another side
    ply = os.path.join(workdir, "cli_trained.ply")
    res = run("train", scene, "--target", png, "--out", ply, "--steps", "4",
              "--radius", "3.0", "--azimuth", "25.0")
    size = os.path.getsize(ply) if os.path.exists(ply) else 0
    emit("cli", command="train", returncode=res.returncode, ply_bytes=size,
         stdout=res.stdout.strip().splitlines()[-1:])
    check(res.returncode == 0 and size > 0, f"cli train failed: {res.stderr[-2000:]}")
    fitted = load_gaussians(ply, device=DEVICE)
    check(bool(torch.isfinite(fitted.means).all()), "cli train wrote non-finite means")

    cli_view(ply_path, workdir)

    res = run("validate", scene)
    ok_lines = [ln for ln in res.stdout.splitlines() if ln.startswith("OK ")]
    emit("cli", command="validate", returncode=res.returncode, stdout=res.stdout.strip())
    check(res.returncode == 0 and len(ok_lines) == 2,
          f"cli validate: {res.stdout} {res.stderr[-2000:]}")


def as_output(out):
    """What seeded_loss reads of a RenderOutput, from a ShardedRender too."""
    if hasattr(out, "alpha"):
        return out
    return types.SimpleNamespace(image=out.image, depth=out.depth, alpha=1.0 - out.t_final)


def leaf_grads(model, out, seed):
    """{leaf: gradient} of seeded_loss(out) (the model's .grad cleared first)."""
    model.zero_grad(set_to_none=True)
    seeded_loss(as_output(out), seed).backward()
    grads = {k: getattr(model, k).grad.detach().clone() for k in model.LEAVES}
    model.zero_grad(set_to_none=True)
    return grads


def grad_report(got, want):
    """Per leaf (max abs error, elements over tolerance), rows flattened."""
    report = {}
    for k in want:
        g, w = (x.reshape(x.shape[0], -1) for x in (got[k], want[k]))
        err, over = grad_errors(g, w)
        report[k] = {"max_abs_err": err, "n_over": over, "finite": bool(torch.isfinite(g).all())}
    return report


def ulp_diff(a, b):
    """Largest distance in float32 ulps between two tensors' finite entries
    (0: bitwise equal there)."""
    both = torch.isfinite(a) & torch.isfinite(b)
    ia, ib = a[both].view(torch.int32).long(), b[both].view(torch.int32).long()
    # order the bit patterns like the floats: negative values mirrored
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max()) if ia.numel() else 0


def records_premise(model, camera, config, ndev):
    """The premise of a bitwise sharded image: the records that projection
    computes on each of ndev blocks equal, bit for bit, the rows it computes
    on all N splats. Returns (equal, largest ulp distance, max abs diff)."""
    with torch.no_grad():
        whole = sharded._pack_features(model, camera, config)
        plan = sharded.band_plan(config, model.num_gaussians, camera.height, ndev)
        blocks = sharded._records_in_process(model, camera, config, plan)[0][0]
    return (bool(torch.equal(whole, blocks)), ulp_diff(whole, blocks),
            float((whole - blocks).abs().nan_to_num(0.0).max()))


@torch.no_grad()
def image_agreement(got, want, bitwise):
    """Report of a sharded frame against the single-card render: bitwise
    equal, or (when the records differ) within ATOL/RTOL."""
    report = {}
    for name, g, w in (("image", got.image, want.image), ("alpha", 1.0 - got.t_final, want.alpha),
                       ("depth", got.depth, want.depth)):
        err = (g - w).abs()
        report[name] = {"bitwise_equal": bool(torch.equal(g, w)), "max_abs_err": float(err.max()),
                        "n_over": int((err > ATOL + RTOL * w.abs()).sum())}
    ok = all(r["bitwise_equal"] if bitwise else r["n_over"] == 0 for r in report.values())
    return ok, report


def band_kernel_ms(model, camera, config, ndev, reps):
    """Per band: pairs, the table's rows and kernel_ms of raster_fwd and
    raster_bwd (seeded unit cotangents) on that band's own inputs."""
    bands = []
    for b in range(ndev):
        binning, args, row0, h = band_raster_inputs(
            model, camera, config, ndev, b, config.shard_exchange)
        walked = torch.zeros_like(args[3])
        with torch.no_grad():
            rgbd, t_final = cuda_raster.raster_forward(
                *args, WIDTH, h, config, walked=walked, tile_row0=row0)
            gen = torch.Generator(device=DEVICE).manual_seed(7)
            cot = (torch.randn((h, WIDTH, 4), generator=gen, device=DEVICE),
                   torch.randn((h, WIDTH), generator=gen, device=DEVICE))
            bwd_args = (*args, rgbd, t_final, *cot, WIDTH, h, config)
            bands.append({
                "band": b, "tile_row0": row0, "num_pairs": int(binning.num_pairs),
                "table_rows": binning.num_active,
                "raster_fwd_kernel_ms": time_ms(lambda: cuda_raster.raster_forward(
                    *args, WIDTH, h, config, tile_row0=row0), reps),
                "raster_bwd_kernel_ms": time_ms(lambda: cuda_raster.raster_backward(
                    *bwd_args, walked=walked, tile_row0=row0), reps),
            })
    return bands


def phase_band_path(model, camera, smi):
    """The sharded path on one card: BANDS bands in this process through the
    ranks' own functions (`sharded_render.render_bands_in_process`: pack,
    exchange, render one band), both exchanges, held against the
    single-card render — the frame bitwise (or, where the records differ,
    within ATOL/RTOL), every band's sentinels 0, the gradients of a seeded
    loss within GRAD_RTOL/GRAD_ATOL_REL — and BANDS launches of each kernel a
    frame (forward and backward)."""
    config = calibrate_render_config(model, camera, RenderConfig(), mesh_ndev=BANDS)
    premise, ulps, diff = records_premise(model, camera, config, BANDS)
    single = render(model, camera, config)
    want = leaf_grads(model, single, 13)
    report = {"records_equal": premise, "records_max_ulps": ulps, "records_max_abs_diff": diff,
              "shard_capacity_margin": config.shard_capacity_margin}
    launches = dict.fromkeys(cuda_raster.KERNELS, 0)
    for exchange in ("all_gather", "all_to_all"):
        cfg = dataclasses.replace(config, shard_exchange=exchange)
        plan = sharded.band_plan(cfg, model.num_gaussians, HEIGHT, BANDS)
        cuda_raster.reset_launch_counts()
        out = sharded.render_bands_in_process(model, camera, cfg, BANDS)
        got = leaf_grads(model, out, 13)
        frame_launches = dict(cuda_raster.launch_counts)
        for k in cuda_raster.KERNELS:
            launches[k] += frame_launches[k]
        ok, agreement = image_agreement(out, single, premise)
        stats = {k: v.tolist() for k, v in out.stats._asdict().items()}
        grads = grad_report(got, want)
        with torch.no_grad():
            frame_ms = time_ms(
                lambda: sharded.render_bands_in_process(model, camera, cfg, BANDS), 3)
        report[exchange] = {
            "image": agreement, "stats": stats, "grads": grads, "launches": frame_launches,
            "max_active": plan.max_active if exchange == "all_gather" else None,
            "a2a_cap": plan.a2a_cap if exchange == "all_to_all" else None,
            "frame_ms_bands_in_process": frame_ms,
            "bands": band_kernel_ms(model, camera, cfg, BANDS, reps=5),
        }
        check(ok, f"band_path {exchange}: the stitched frame differs from the single "
              f"card's (records equal: {premise}, {ulps} ulps): {agreement}")
        check(all(v == 0 for k in SENTINELS for v in stats[k]),
              f"band_path {exchange}: a band's sentinel fired: {stats}")
        check(all(g["n_over"] == 0 and g["finite"] for g in grads.values()),
              f"band_path {exchange}: gradients differ from the single card's: {grads}")
        check(frame_launches == dict.fromkeys(cuda_raster.KERNELS, BANDS),
              f"band_path {exchange}: expected {BANDS} launches of each kernel a frame: "
              f"{frame_launches}")
    emit("band_path", gpu=smi, n_splats=model.num_gaussians, width=WIDTH, height=HEIGHT,
         bands=BANDS, single_num_pairs=int(single.stats.num_pairs),
         rtol=GRAD_RTOL, atol_rel=GRAD_ATOL_REL, **report)
    return launches


def sharded_checkpoint(ckpt, fitted, tc, mesh, gathered, lead):
    """The newest checkpoint of fit(mesh=): on rank 0, the whole model (N
    rows) bit for bit the ranks' fitted blocks gathered; on every rank, its
    block restored bit for bit."""
    whole = {k: gathered(getattr(fitted, k).detach()) for k in fitted.LEAVES}
    restored = restore_checkpoint(ckpt, trainer.create_train_state(fitted, tc), mesh)
    report = {"step": restored.step, "restored_rank_bitwise": all(
        torch.equal(getattr(restored.model, k), getattr(fitted, k)) for k in fitted.LEAVES)}
    check(restored.step == tc.num_steps and report["restored_rank_bitwise"],
          f"multi_gpu checkpoint: this rank's block did not come back: {report}")
    if lead:
        path = os.path.join(ckpt, f"step_{latest_step(ckpt):08d}.pt")
        saved = torch.load(path, map_location=DEVICE, weights_only=True)
        report.update(files=sorted(os.listdir(ckpt)),
                      rows=int(saved["model"]["means"].shape[0]),
                      moment_rows=int(saved["optimizer"]["state"][0]["exp_avg"].shape[0]),
                      saved_bitwise=all(torch.equal(saved["model"][k], whole[k]) for k in whole))
        check(report["rows"] == report["moment_rows"] == N_SPLATS and report["saved_bitwise"],
              f"multi_gpu checkpoint: rank 0's file is not the whole fitted model: {report}")
    return report


def _multi_gpu_rank(rank, ndev, port, out_path):
    """One rank of the multi_gpu phase (run in its own process on cuda:rank).
    Rank 0 writes the phase's report to out_path."""
    from gaussian_splat_tpu_torch.parallel.mesh import make_mesh, shard_model

    mesh = make_mesh(ndev, device=DEVICE, rank=rank, init_method=f"tcp://127.0.0.1:{port}")
    group = mesh.get_group("dev")
    model, camera = bench_scene()  # the same seeded scene on every card
    config = calibrate_render_config(model, camera, RenderConfig(), mesh_ndev=ndev)
    block = shard_model(model, mesh)
    lead = rank == 0
    report = {"ndev": ndev, "shard_capacity_margin": config.shard_capacity_margin}
    if lead:
        premise, ulps, _ = records_premise(model, camera, config, ndev)
        single = render(model, camera, config)
        want = leaf_grads(model, single, 13)
        report.update(records_equal=premise, records_max_ulps=ulps,
                      single_num_pairs=int(single.stats.num_pairs))

    def gathered(t):
        """Every rank's block of t, stacked in rank order (on every rank)."""
        out = t.new_empty((ndev * t.shape[0], *t.shape[1:]))
        torch.distributed.all_gather_into_tensor(out, t.contiguous(), group=group)
        return out

    for exchange in ("all_gather", "all_to_all"):
        cfg = dataclasses.replace(config, shard_exchange=exchange)
        cuda_raster.reset_launch_counts()
        out = sharded.render_sharded(block, camera, cfg, mesh)
        launches = dict(cuda_raster.launch_counts)
        block.zero_grad(set_to_none=True)
        seeded_loss(as_output(out), 13).backward()
        got = {k: gathered(getattr(block, k).grad) for k in block.LEAVES}
        block.zero_grad(set_to_none=True)
        with torch.no_grad():
            again = sharded.render_sharded(block, camera, cfg, mesh)
            torch.cuda.synchronize()
            frame_ms = []
            for _ in range(5):
                t0 = time.perf_counter()
                sharded.render_sharded(block, camera, cfg, mesh)
                torch.cuda.synchronize()
                frame_ms.append((time.perf_counter() - t0) * 1e3)
            plan = sharded.band_plan(cfg, model.num_gaussians, HEIGHT, ndev)
            feats = sharded._pack_features(block, camera, cfg)
            if exchange == "all_gather":
                def exchange_fn():
                    return sharded._Gather.apply(feats, group, False)
                sent = feats.numel() * 4  # each rank's records, to every other rank
                moved = sent * (ndev - 1)
            else:
                send, _ = sharded._route(feats, plan)

                def exchange_fn():
                    return sharded._AllToAll.apply(send.reshape(-1, sharded.NFEAT_X), group)
                sent = send.numel() * 4
                moved = sent * (ndev - 1) // ndev
            exchange_ms = time_ms(exchange_fn, 5)
        stats = {k: v.tolist() for k, v in out.stats._asdict().items()}
        entry = {
            "launches_rank": launches, "stats": stats, "num_pairs_per_band": stats["num_pairs"],
            "two_runs_bitwise_equal": bool(torch.equal(out.image, again.image)),
            "frame_ms_sharded": statistics.median(frame_ms), "frame_ms_all": frame_ms,
            "exchange_ms": exchange_ms, "exchange_bytes_sent_per_rank": sent,
            "exchange_bytes_received_per_rank": moved,
            "records_bytes_total": model.num_gaussians * sharded.NFEAT_X * 4,
            # each rank receives `moved` bytes; NVLink moves 450 GB/s each way a card
            "exchange_bound_ms": roofline.nvlink_ms(moved),
        }
        check(entry["two_runs_bitwise_equal"], f"multi_gpu {exchange}: two runs differ")
        check(all(v == 0 for k in SENTINELS for v in stats[k]),
              f"multi_gpu {exchange}: a band's sentinel fired: {stats}")
        check(launches["raster_fwd"] == 1, f"multi_gpu {exchange}: launches {launches}")
        if lead:
            ok, agreement = image_agreement(out, single, premise)
            grads = grad_report(got, want)
            entry.update(image=agreement, grads=grads)
            check(ok, f"multi_gpu {exchange}: rank 0's frame differs from the single card's: "
                  f"{agreement}")
            check(all(g["n_over"] == 0 and g["finite"] for g in grads.values()),
                  f"multi_gpu {exchange}: gradients differ from the single card's: {grads}")
        report[exchange] = entry

    # a tiny all_to_all send buffer must drop splats, and say so
    tiny = dataclasses.replace(config, shard_exchange="all_to_all", a2a_capacity_factor=0.25,
                               shard_capacity_floor=0)
    with torch.no_grad():
        drops = sharded.render_sharded(block, camera, tiny, mesh).stats.dropped_gaussians
    report["tiny_a2a_dropped_gaussians"] = drops.tolist()
    check(int(drops.sum()) > 0, "multi_gpu: a tiny all_to_all buffer reported no drop")

    # fit(mesh=): every rank fits its block; rank 0 also fits the whole model
    truth = perturbed(model, seed=3)
    with torch.no_grad():
        target = render(truth, camera, config).image.contiguous()
    torch.distributed.broadcast(target, src=0, group=group)
    # checkpoints at half way and at the end: rank 0 writes the whole state
    ckpt = os.path.join(os.path.dirname(out_path), "ckpt")
    tc = TrainConfig(num_steps=FIT_STEPS, checkpoint_dir=ckpt, checkpoint_every=FIT_STEPS // 2)
    step_ms, save_ms, clock = [], [], {"t": None}

    def on_step(i, loss, state):
        torch.cuda.synchronize()
        now = time.perf_counter()
        # the interval that ends at step i holds the save after step i - 1
        # when that one was due: it is kept apart
        if clock["t"] is not None:
            (save_ms if i % tc.checkpoint_every == 0 else step_ms).append(
                (now - clock["t"]) * 1e3)
        clock["t"] = now

    cuda_raster.reset_launch_counts()
    fitted, history = fit(block, camera, target, config, tc, mesh=mesh, log_every=1,
                          callback=on_step)
    fit_launches = dict(cuda_raster.launch_counts)
    report["fit"] = {"losses": history, "step_ms_sharded": statistics.median(step_ms),
                     "step_ms_all": step_ms, "step_and_save_ms": save_ms,
                     "launches_rank": fit_launches}
    report["fit"]["checkpoint"] = sharded_checkpoint(ckpt, fitted, tc, mesh, gathered, lead)
    check(len(history) == FIT_STEPS and all(np.isfinite(history)) and history[-1] < history[0],
          f"multi_gpu fit(mesh=): the loss did not fall: {history}")
    check(all(v == FIT_STEPS for v in fit_launches.values()),
          f"multi_gpu fit(mesh=): expected one launch of each kernel a step: {fit_launches}")
    if lead:
        _, single_history = fit(model, camera, target, config, tc, log_every=1)
        gap = max(abs(a - b) / b for a, b in zip(history, single_history))
        report["fit"].update(single_losses=single_history, max_rel_gap=gap,
                             max_rel_gap_limit=FIT_TRACK_RTOL)
        check(gap <= FIT_TRACK_RTOL,
              f"multi_gpu fit(mesh=) strays from the single card's: {history} vs {single_history}")
        with open(out_path, "w") as f:
            json.dump(report, f)
    torch.distributed.barrier(group)
    torch.distributed.destroy_process_group()


def phase_multi_gpu(smi):
    """render_sharded and fit(mesh=) over every visible card, one process a
    card over NCCL (`make_mesh` → `shard_model` → `render_sharded`), at full
    width; the kernels are built here first, so the ranks only load them.
    With one card it says so on one line and runs nothing."""
    cards = torch.cuda.device_count()
    if cards < 2:
        emit("multi_gpu", ran=False, cards=cards)
        return
    t_start = time.perf_counter()
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "multi_gpu.json")
        ctx = torch.multiprocessing.start_processes(
            _multi_gpu_rank, args=(cards, port, out_path), nprocs=cards, join=False,
            start_method="spawn")
        deadline = time.monotonic() + MULTI_GPU_TIMEOUT
        try:
            # join raises as soon as a rank fails, and ends the others
            while not ctx.join(timeout=5):
                check(time.monotonic() < deadline,
                      f"multi_gpu: the ranks did not finish in {MULTI_GPU_TIMEOUT} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join(timeout=30)
        with open(out_path) as f:
            report = json.load(f)
    emit("multi_gpu", ran=True, cards=cards, gpu=smi, n_splats=N_SPLATS, width=WIDTH,
         height=HEIGHT, seconds=time.perf_counter() - t_start, **report)


KERNEL_TABLE = {
    # name: (source, file:line of the TPU kernel it replaces)
    "raster_fwd": ("gaussian_splat_tpu_torch/csrc/raster_fwd.cu",
                   "gaussian_splat_tpu/ops/pallas_raster.py:312"),
    "raster_bwd": ("gaussian_splat_tpu_torch/csrc/raster_bwd.cu",
                   "gaussian_splat_tpu/ops/pallas_raster.py:525"),
    # no pallas_call: the lax.sort of the pairs in _gather_pairs_t_bwd
    "rank_perm": ("gaussian_splat_tpu_torch/csrc/rank_perm.cu",
                  "gaussian_splat_tpu/ops/pallas_raster.py:1082"),
    "segsum": ("gaussian_splat_tpu_torch/csrc/segsum.cu",
               "gaussian_splat_tpu/ops/pallas_raster.py:897"),
    # no pallas_call: XLA fused eval_sh and its VJP on the TPU
    "sh_fwd": ("gaussian_splat_tpu_torch/csrc/sh.cu",
               "none: XLA fused gaussian_splat_tpu/ops/sh.py:44"),
    "sh_bwd": ("gaussian_splat_tpu_torch/csrc/sh.cu",
               "none: XLA fused the VJP of gaussian_splat_tpu/ops/sh.py:44"),
    # no pallas_call: XLA fused project_gaussians and view_directions
    "proj_fwd": ("gaussian_splat_tpu_torch/csrc/projection.cu",
                 "none: XLA fused gaussian_splat_tpu/ops/projection.py:136 and :271"),
    "proj_bwd": ("gaussian_splat_tpu_torch/csrc/projection.cu",
                 "none: XLA fused the VJP of gaussian_splat_tpu/ops/projection.py:136 and :271"),
    # no pallas_call: XLA sorted padded (tile, rank) keys with lax.sort; one
    # entry for the chain of four kernels
    "binning": ("gaussian_splat_tpu_torch/csrc/binning.cu",
                "none: XLA's lax.sort of padded keys, gaussian_splat_tpu/ops/binning.py:633"),
}
# an entry of the kernels line that covers a chain of kernels: its launches
# are each kernel's, equal on every path
CHAINS = {"binning": binning_ops.KERNELS}


def kernel_line(cases, launches, smi):
    """The kernels line: each kernel with its full-size cases and its
    launches on every path."""
    kernels = []
    for name, (source, replaces) in KERNEL_TABLE.items():
        full = next(c for c in cases[name] if c["case"] == "bench_full")
        band = next((c for c in cases[name] if c["case"] == FULL_BAND_CASE), None)
        chain = CHAINS.get(name, (name,))
        for counts in launches.values():
            check(len({counts[k] for k in chain}) == 1,
                  f"{name}: its kernels' launches differ: {counts}")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "kernels": chain,
            "launches": sum(path[chain[0]] for path in launches.values()),
            **{f"launches_{path}": counts[chain[0]] for path, counts in launches.items()},
            "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
            "n_over": sum(c["n_over"] for c in cases[name]),
            # one call per event pair (the host's time to issue it included),
            # the measure of every slice; beside it, the time per call of
            # calls issued back to back and the profiler's device time
            "ms": full["kernel_ms"], "kernel_ms": full["kernel_ms"],
            "plain_ms": full["plain_ms"], "bound_ms": full["bound_ms"],
            "bound_by": full["bound_by"], "library_ms": full.get("library_ms"),
            "share_of_bound": full["bound_ms"] / full["kernel_ms"],
            # the same on the device's own clock: for a small kernel the
            # host's 16-36 us a launch hide the device's share
            "share_of_bound_device": full["device_ms"] and full["bound_ms"] / full["device_ms"],
            "kernel_ms_back_to_back": full["kernel_ms_back_to_back"],
            "device_ms": full["device_ms"],
            "perm_ms": full.get("perm_ms"), "rank_sort_ms": full.get("rank_sort_ms"),
            "live_warp_pair_share": full.get("live_warp_pair_share"),
            # the same at full size on band FULL_BAND of BANDS (tile_row0 34)
            "band_case": FULL_BAND_CASE, "band_kernel_ms": band and band["kernel_ms"],
            "band_kernel_ms_back_to_back": band and band["kernel_ms_back_to_back"],
            "band_device_ms": band and band["device_ms"],
            "band_bound_ms": band and band["bound_ms"],
            "tolerance": (
                {"atol": ATOL, "rtol": RTOL} if name in ("raster_fwd", "sh_fwd")
                else {"exact": True} if name in ("rank_perm", "proj_fwd", "binning")
                else {"rtol": GRAD_RTOL, "atol_rel_to_column_max": GRAD_ATOL_REL,
                      "kink_rows_left_out_below": SH_KINK} if name == "sh_bwd"
                else {"rtol": GRAD_RTOL, "atol_rel_to_column_max": GRAD_ATOL_REL}
            ),
            "gpu": smi, "cases": cases[name],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    check(all(k["share_of_bound"] <= 1.0 for k in kernels),
          "a kernel reads faster than its bound: the bound's count is wrong")
    # serving frames launches no backward kernel; the viewer's only backward
    # (measure_splat_contributions) takes no SH gradient
    wanted = {"main_path": ("raster_fwd", "sh_fwd", "proj_fwd", *binning_ops.KERNELS),
              "view_path": tuple(k for k in cuda_raster.KERNELS
                                 if k not in ("sh_bwd", "proj_bwd"))}
    for path, counts in launches.items():
        want = wanted.get(path, cuda_raster.KERNELS)
        check(all(counts[k] > 0 for k in want),
              f"a kernel was never launched on {path}: {counts}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", choices=["multi_gpu"],
                        help="run the multi-card phase alone (after env and build)")
    only_multi_gpu = parser.parse_args(argv).only == "multi_gpu"

    t_start = time.perf_counter()
    smi = phase_env()
    phase_build()
    if not only_multi_gpu:
        phase_golden()
        phase_golden_grad()
        phase_no_fallback()
        model, camera = bench_scene()
        with tempfile.TemporaryDirectory() as workdir:
            launches = {"main_path": phase_main_path(model, camera, smi),
                        "train_path": phase_train_path(model, camera, smi, workdir)}
            launches["view_path"], ply_path = phase_view_path(model, camera, smi, workdir)
            launches["band_path"] = phase_band_path(model, camera, smi)
            config = calibrate_render_config(model, camera, RenderConfig())
            kernel_line(phase_kernels(model, camera, config), launches, smi)
            phase_cli(workdir, ply_path)
    phase_multi_gpu(smi)
    emit("done", seconds=time.perf_counter() - t_start)

    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
