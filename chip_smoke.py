"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two paths on the GPU through the entry points a user calls
— serving frames and training — builds every hand-written CUDA kernel from
csrc/, holds each against its plain PyTorch version on the card, and shows
that each path went through its kernels (launch counts). One JSON object per
line:

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
  kernels    each kernel vs its plain version: errors, times, bound, launches;
             the raster kernels' own count of kept steps vs the plain count
             (their per-warp cull dropped nothing) and the share of
             (warp, pair)s the cull let through
  cli        `cli render` and `cli train` as subprocesses
  last line  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Any failed check raises: the process exits non-zero and prints no last line.
Without a GPU it exits with code 2 before running anything.
"""

import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

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
from gaussian_splat_tpu_torch.io.ply import load_gaussians  # noqa: E402
from gaussian_splat_tpu_torch.ops import cuda_raster, tile_raster  # noqa: E402
from gaussian_splat_tpu_torch.ops.binning import bin_gaussians  # noqa: E402
from gaussian_splat_tpu_torch.ops.render import (  # noqa: E402
    _effective_opacities, _project_and_shade,
)
from gaussian_splat_tpu_torch.train import trainer  # noqa: E402
from gaussian_splat_tpu_torch.train.checkpoint import latest_step  # noqa: E402
from gaussian_splat_tpu_torch.train.dataset import orbit_dataset  # noqa: E402
from gaussian_splat_tpu_torch.train.loss import photometric_loss  # noqa: E402
from gaussian_splat_tpu_torch.viewer.viewer import Viewer  # noqa: E402

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

# Published peaks of one H100 SXM (NVIDIA data sheet): float32 outside the
# tensor cores, and HBM3 bandwidth. The bound is stated against these.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
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
    binning = bin_gaussians(proj, camera.width, camera.height, config, opacities=opacities)
    table = tile_raster.build_splat_table(proj, colors, opacities, binning.order, config)
    args = (table, binning.pair_gauss, binning.tile_offsets, binning.tile_counts)
    return (proj, colors, opacities), binning, args


@torch.no_grad()
def count_steps(args, walked, width, height, config):
    """The (pixel, pair) steps that this run's data asks of raster_fwd, counted
    in plain torch over the pairs each tile walked before it left its loop
    (`walked`, read back from the kernel) and the pixels inside the image:
    (all steps, steps that pass the keep test, (warp, pair)s that the plain
    mirror of the kernels' per-warp cull lets through)."""
    table, pair_gauss, tile_offsets, tile_counts = args
    tx_n = config.tiles_x(width)
    tw, th = config.tile_width, config.tile_height
    rects = torch.from_numpy(tile_raster.tile_warp_rects(tw, th)).to(table.device)
    steps = kept = live_warp_pairs = 0
    for t0, t1 in tile_raster.tile_batches(tile_offsets, tile_counts, 1 << 16):
        rows, local_tile, start, px, py, sigma = tile_raster.pair_pixel_sigma(
            table, pair_gauss, tile_offsets, tile_counts, tx_n, config, (t0, t1)
        )
        tile = local_tile + t0
        index_in_tile = (
            torch.arange(rows.shape[0], device=rows.device) + start - tile_offsets[tile]
        )
        live = (index_in_tile < walked[tile])[:, None] & (px < width) & (py < height)
        bound = rows[:, tile_raster.COL_BOUND : tile_raster.COL_BOUND + 1]
        steps += int(live.sum())
        kept += int((live & (sigma >= 0.0) & (sigma <= bound)).sum())
        # each warp's pixel-centre rectangle in the pair's tile: (b, warps)
        tx0 = ((tile % tx_n) * tw)[:, None]
        ty0 = (torch.div(tile, tx_n, rounding_mode="floor") * th)[:, None]
        corners = (tx0 + rects[:, 0], tx0 + rects[:, 1], ty0 + rects[:, 2], ty0 + rects[:, 3])
        miss = tile_raster.extent_misses_rect(
            tile_raster.splat_extent_torch(rows)[:, None, :],
            *(v.to(torch.float32) + 0.5 for v in corners))
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


def bound_fields(n_bytes, flops):
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    return {
        "bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms, "ops_ms": ops_ms,
        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        "bytes": n_bytes, "flops": flops,
    }


@torch.no_grad()
def compare_kernels(name, model, camera, config, reps, tamper=None):
    """The three kernels vs their plain versions on one frame's binning:
    {kernel name: case}. The backward kernels get seeded cotangents of unit
    scale, and are run twice to show that their results are bitwise equal.
    Both raster kernels also count their kept steps and the (warp, pair)s
    their cull let through; the first must equal the plain count."""
    w, h = camera.width, camera.height
    _, binning, args = raster_inputs(model, camera, config)
    if tamper is not None:
        args = (tamper(args[0]), *args[1:])
    table, pair_gauss, tile_offsets, tile_counts = args
    rank_starts = binning.rank_starts
    n = model.num_gaussians
    pairs = int(binning.num_pairs) - int(binning.overflow)
    shape = {"case": name, "n_splats": n, "width": w, "height": h, "pairs": pairs}

    # -- raster_fwd --------------------------------------------------------
    walked = torch.zeros_like(tile_counts)
    n_tiles = tile_counts.numel()
    counted = torch.zeros((n_tiles, 2), dtype=torch.int32, device=DEVICE)
    rgbd, t_final = cuda_raster.raster_forward(
        *args, w, h, config, walked=walked, counters=counted)
    plain_rgbd, plain_t = cuda_raster.raster_forward(*args, w, h, config)
    want = tile_raster.raster_forward_torch(*args, w, h, config)
    torch.cuda.synchronize()
    got_all = torch.cat([rgbd, t_final[..., None]], dim=-1)
    want_all = torch.cat([want[0], want[1][..., None]], dim=-1)
    check(bool(torch.isfinite(got_all).all()), f"{name}: raster_fwd output not finite")
    err = (got_all - want_all).abs()
    over = (err > ATOL + RTOL * want_all.abs()).any(dim=-1)
    steps, kept_steps, live_plain = count_steps(args, walked, w, h, config)
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
        "kernel_ms": time_ms(lambda: cuda_raster.raster_forward(*args, w, h, config), reps),
        "plain_ms": time_ms(
            lambda: tile_raster.raster_forward_torch(*args, w, h, config),
            max(1, reps // 4), warmup=0),
        # each input read once, each output written once; the operations that
        # this run's data needs
        **bound_fields(
            table.numel() * 4 + pairs * 4 + 2 * n_tiles * 4 + h * w * 5 * 4,
            steps * FLOPS_PER_STEP + kept_steps * FLOPS_PER_KEPT_STEP),
    }

    # -- raster_bwd --------------------------------------------------------
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    d_rgbd = torch.randn((h, w, 4), generator=gen, device=DEVICE)
    d_t = torch.randn((h, w), generator=gen, device=DEVICE)
    bwd_args = (*args, rgbd, t_final, d_rgbd, d_t, w, h, config)
    counted = torch.zeros_like(counted)
    rows = cuda_raster.raster_backward(*bwd_args, walked=walked, counters=counted)
    rows_again = cuda_raster.raster_backward(*bwd_args, walked=walked)
    t0 = time.perf_counter()
    want_rows = tile_raster.raster_backward_torch(*bwd_args, walked=walked)
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
            lambda: cuda_raster.raster_backward(*bwd_args, walked=walked), reps),
        "plain_ms": plain_bwd_ms,
        **bound_fields(
            table.numel() * 4 + pairs * 4 + 3 * n_tiles * 4 + h * w * 10 * 4
            + num_rows * cuda_raster.ROW_COLS * 4,
            steps * FLOPS_PER_STEP + kept_steps * FLOPS_PER_KEPT_STEP_BWD),
    }

    # -- segsum (on the rows the backward kernel made) -----------------------
    perm = tile_raster.rank_permutation(pair_gauss, rank_starts, n)
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
        "kernel_ms": time_ms(
            lambda: cuda_raster.segment_sum(rows, perm, rank_starts, n), reps),
        "plain_ms": time_ms(
            lambda: tile_raster.segment_sum_torch(rows, perm, rank_starts, n), reps),
        "library_ms": time_ms(library, reps),
        "rank_sort_ms": time_ms(
            lambda: tile_raster.rank_permutation(pair_gauss, rank_starts, n), reps),
        # rows and permutation of the real pairs read once, rank_starts read
        # once, the table's gradient written once; one addition per value read
        **bound_fields(
            pairs * (cuda_raster.ROW_COLS * 4 + 8) + (n + 1) * 4
            + n * cuda_raster.ROW_COLS * 4,
            pairs * cuda_raster.ROW_COLS),
    }
    return {"raster_fwd": fwd, "raster_bwd": bwd, "segsum": seg}


def phase_kernels(model, camera, config):
    """{kernel name: [case, ...]} over the small shapes and the full frame."""
    runs = [
        compare_kernels(name, m, cam, cfg, reps=5, tamper=tamper)
        for name, m, cam, cfg, tamper in small_scenes()
    ]
    runs.append(compare_kernels("bench_full", model, camera, config, reps=10))
    cases = {k: [run[k] for run in runs] for k in cuda_raster.KERNELS}
    for kernel, kernel_cases in cases.items():
        for c in kernel_cases:
            check(c["n_over"] == 0,
                  f"{kernel} differs from its plain version on {c['case']}: "
                  f"{c['n_over']} elements, max abs err {c['max_abs_err']}")
            check(c.get("bitwise_repeatable", True),
                  f"{kernel}: two runs on {c['case']} are not bitwise equal")
            check(c.get("pad_columns_and_rows_zero", True),
                  f"{kernel}: padding rows or columns not zero on {c['case']}")
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
    whichever of the three kernels it is; nothing gives way to a plain version
    or to autograd through one."""
    _, model, cam, cfg, _ = small_scenes()[0]
    real = _build.load_library
    raised = {}
    for broken in cuda_raster.KERNELS:
        def load(name, broken=broken):
            if name == broken:
                raise _build.KernelCompileError(f"build of {name} made to fail")
            return real(name)

        _build.load_library = load
        try:
            try:
                render(model, cam, cfg).image.sum().backward()
                raised[broken] = False
            except _build.KernelCompileError:
                raised[broken] = True
        finally:
            _build.load_library = real
    emit("no_fallback", raised_on_failed_build=raised)
    check(all(raised.values()),
          f"a training step survived a failed kernel build: {raised}")


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
    check(all_launches["raster_bwd"] == 0 and all_launches["segsum"] == 0,
          f"serving frames launched a backward kernel: {all_launches}")

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
    perm = tile_raster.rank_permutation(binning.pair_gauss, binning.rank_starts, n)
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
        "rank_sort_ms": time_ms(
            lambda: tile_raster.rank_permutation(binning.pair_gauss, binning.rank_starts, n), 5),
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


def phase_cli(workdir):
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


KERNEL_TABLE = {
    # name: (source, file:line of the TPU kernel it replaces)
    "raster_fwd": ("gaussian_splat_tpu_torch/csrc/raster_fwd.cu",
                   "gaussian_splat_tpu/ops/pallas_raster.py:312"),
    "raster_bwd": ("gaussian_splat_tpu_torch/csrc/raster_bwd.cu",
                   "gaussian_splat_tpu/ops/pallas_raster.py:525"),
    "segsum": ("gaussian_splat_tpu_torch/csrc/segsum.cu",
               "gaussian_splat_tpu/ops/pallas_raster.py:897"),
}


def main():
    t_start = time.perf_counter()
    smi = phase_env()
    phase_build()
    phase_golden()
    phase_golden_grad()
    phase_no_fallback()
    model, camera = bench_scene()
    with tempfile.TemporaryDirectory() as workdir:
        serve_launches = phase_main_path(model, camera, smi)
        train_launches = phase_train_path(model, camera, smi, workdir)
        config = calibrate_render_config(model, camera, RenderConfig())
        cases = phase_kernels(model, camera, config)

        kernels = []
        for name in cuda_raster.KERNELS:
            full = cases[name][-1]
            source, replaces = KERNEL_TABLE[name]
            kernels.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": serve_launches[name] + train_launches[name],
                "launches_main_path": serve_launches[name],
                "launches_train_path": train_launches[name],
                "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
                "n_over": sum(c["n_over"] for c in cases[name]),
                "ms": full["kernel_ms"], "kernel_ms": full["kernel_ms"],
                "plain_ms": full["plain_ms"], "bound_ms": full["bound_ms"],
                "bound_by": full["bound_by"], "library_ms": full.get("library_ms"),
                "share_of_bound": full["bound_ms"] / full["kernel_ms"],
                "live_warp_pair_share": full.get("live_warp_pair_share"),
                "tolerance": (
                    {"atol": ATOL, "rtol": RTOL} if name == "raster_fwd"
                    else {"rtol": GRAD_RTOL, "atol_rel_to_column_max": GRAD_ATOL_REL}
                ),
                "gpu": smi, "cases": cases[name],
            })
        print(json.dumps({"kernels": kernels}), flush=True)
        check(all(k["share_of_bound"] <= 1.0 for k in kernels),
              "a kernel reads faster than its bound: the bound's count is wrong")
        check(all(k["launches_train_path"] > 0 for k in kernels),
              "a kernel was never launched on the training path")
        check(kernels[0]["launches_main_path"] > 0,
              "raster_fwd was never launched on the frame-serving path")
        phase_cli(workdir)
    emit("done", seconds=time.perf_counter() - t_start)

    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
