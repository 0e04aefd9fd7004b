"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's frame-serving path on the GPU through the entry points a
user calls, builds every hand-written CUDA kernel from csrc/, holds each
against its plain PyTorch version on the card, and shows that the main path
went through the kernels (launch counts). One JSON object per line:

  env        GPU name and power limit (as nvidia-smi prints them), versions
  build      seconds to build csrc/, the libraries, the compiler's report
  golden     tests/golden/scene.ply rendered with backend="cuda" vs golden.npy
  no_fallback  a failed kernel build, and a backward through the kernel, raise
  kernels    each kernel vs its plain version: errors, times, bound, launches
  main_path  1M-splat scene at 1920x1080 through Viewer.render_frame
  cli        `python -m gaussian_splat_tpu_torch.cli render` as a subprocess
  last line  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Any failed check raises: the process exits non-zero and prints no last line.
Without a GPU it exits with code 2 before running anything.
"""

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
    Camera, GaussianModel, RenderConfig, _build, calibrate_render_config, render,
)
from gaussian_splat_tpu_torch.io.ply import load_gaussians  # noqa: E402
from gaussian_splat_tpu_torch.ops import cuda_raster, tile_raster  # noqa: E402
from gaussian_splat_tpu_torch.ops.binning import bin_gaussians  # noqa: E402
from gaussian_splat_tpu_torch.ops.render import (  # noqa: E402
    _effective_opacities, _project_and_shade,
)
from gaussian_splat_tpu_torch.viewer.viewer import Viewer  # noqa: E402

DEVICE = "cuda"
# full size: the bench scene of the JAX package (bench.py) — 1M splats, 1080p
N_SPLATS, WIDTH, HEIGHT = 1_000_000, 1920, 1080
ORBIT_FRAMES = 8
ATOL, RTOL = 3e-5, 1e-4  # kernel vs plain version, per channel
GOLDEN_LIMIT = 2e-3

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


def small_scenes():
    """(name, model, camera, config): the two small shapes of the JAX kernel
    tests, and one with other tiles."""
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

    def cam(w, h):
        return Camera.from_lookat(
            (0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, w, h, device=DEVICE
        )

    return [
        ("random120_96x64", rand, cam(96, 64), RenderConfig()),
        ("deep200_64x64", deep, cam(64, 64), RenderConfig()),
        # another tile shape, and an image whose right and bottom edges are ragged
        ("random120_100x70_tiles16x16", rand, cam(100, 70),
         RenderConfig(tile_width=16, tile_height=16)),
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
    (all steps, steps that pass the keep test)."""
    table, pair_gauss, tile_offsets, tile_counts = args
    tx_n = config.tiles_x(width)
    steps = kept = 0
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
    return steps, kept


@torch.no_grad()
def compare_kernel(name, model, camera, config, reps):
    """raster_fwd vs its plain version on the same binning inputs."""
    w, h = camera.width, camera.height
    _, binning, args = raster_inputs(model, camera, config)
    kernel = cuda_raster.raster_forward
    walked = torch.zeros_like(binning.tile_counts)
    got = kernel(*args, w, h, config, walked=walked)
    want = tile_raster.raster_forward_torch(*args, w, h, config)
    torch.cuda.synchronize()

    got_all = torch.cat([got[0], got[1][..., None]], dim=-1)
    want_all = torch.cat([want[0], want[1][..., None]], dim=-1)
    check(bool(torch.isfinite(got_all).all()), f"{name}: kernel output not finite")
    err = (got_all - want_all).abs()
    over = (err > ATOL + RTOL * want_all.abs()).any(dim=-1)
    pairs = int(binning.num_pairs) - int(binning.overflow)
    steps, kept_steps = count_steps(args, walked, w, h, config)

    kernel_ms = time_ms(lambda: kernel(*args, w, h, config), reps)
    plain_ms = time_ms(
        lambda: tile_raster.raster_forward_torch(*args, w, h, config),
        max(1, reps // 4), warmup=0,
    )
    # the least time the card could take: each input read once, each output
    # written once, and the operations that this run's data needs
    table = args[0]
    n_bytes = (
        table.numel() * 4 + pairs * 4 + 2 * binning.tile_counts.numel() * 4
        + h * w * 5 * 4
    )
    flops = steps * FLOPS_PER_STEP + kept_steps * FLOPS_PER_KEPT_STEP
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    return {
        "case": name, "n_splats": model.num_gaussians, "width": w, "height": h,
        "pairs": pairs, "walked_pairs": int(walked.sum()),
        "steps": steps, "kept_steps": kept_steps,
        "max_abs_err": float(err.max()), "n_pixels_over": int(over.sum()),
        "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms, "ops_ms": ops_ms,
        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        "bytes": n_bytes, "flops": flops,
    }


def phase_kernels(model, camera, config):
    cases = [
        compare_kernel(name, m, cam, cfg, reps=5)
        for name, m, cam, cfg in small_scenes()
    ]
    cases.append(compare_kernel("bench_full", model, camera, config, reps=10))
    for c in cases:
        check(c["n_pixels_over"] == 0,
              f"raster_fwd differs from its plain version on {c['case']}: "
              f"{c['n_pixels_over']} pixels, max abs err {c['max_abs_err']}")
    return cases


def phase_no_fallback():
    """On CUDA tensors a kernel that cannot be built or differentiated raises;
    nothing gives way to the plain version."""
    _, model, cam, cfg = small_scenes()[0]

    def broken_build():
        raise _build.KernelCompileError("build made to fail")

    real = cuda_raster._library
    cuda_raster._library = broken_build
    try:
        try:
            render(model, cam, cfg)
            raised_on_build = False
        except _build.KernelCompileError:
            raised_on_build = True
    finally:
        cuda_raster._library = real
    try:
        render(model, cam, cfg).image.sum().backward()
        raised_on_backward = False
    except NotImplementedError:
        raised_on_backward = True
    emit("no_fallback", raised_on_build=raised_on_build,
         raised_on_backward=raised_on_backward)
    check(raised_on_build, 'render(backend="auto") survived a failed kernel build')
    check(raised_on_backward, "backward through the CUDA kernel did not raise")


def phase_main_path(model, camera, smi):
    """Viewer frames at full size: orbit poses plus the bench pose."""
    from gaussian_splat_tpu_torch.camera import orbit_camera

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
    cuda_raster.reset_launch_count()

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
    turntable_launches = cuda_raster.launch_count
    for cam in [*orbit, camera]:
        last = one(cam)
    launches = cuda_raster.launch_count
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
    return launches


def phase_cli():
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cli_render.png")
        cmd = [sys.executable, "-m", "gaussian_splat_tpu_torch.cli", "render",
               os.path.join("tests", "golden", "scene.ply"), "--out", out]
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        size = os.path.getsize(out) if os.path.exists(out) else 0
        emit("cli", returncode=res.returncode, png_bytes=size, stdout=res.stdout.strip())
        check(res.returncode == 0 and size > 0, f"cli render failed: {res.stderr[-2000:]}")


def main():
    t_start = time.perf_counter()
    smi = phase_env()
    phase_build()
    phase_golden()
    phase_no_fallback()
    model, camera = bench_scene()
    config = calibrate_render_config(model, camera, RenderConfig())
    cases = phase_kernels(model, camera, config)
    launches = phase_main_path(model, camera, smi)

    full = cases[-1]
    kernels = [{
        "name": "raster_fwd", "route": "cuda",
        "source": "gaussian_splat_tpu_torch/csrc/raster_fwd.cu",
        "replaces": "gaussian_splat_tpu/ops/pallas_raster.py:312",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "n_pixels_over": sum(c["n_pixels_over"] for c in cases),
        "ms": full["kernel_ms"], "kernel_ms": full["kernel_ms"],
        "plain_ms": full["plain_ms"], "bound_ms": full["bound_ms"],
        "bound_by": full["bound_by"], "library_ms": None,
        "tolerance": {"atol": ATOL, "rtol": RTOL}, "gpu": smi, "cases": cases,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    check(all(k["launches"] > 0 for k in kernels), "a kernel was never launched")
    phase_cli()
    emit("done", seconds=time.perf_counter() - t_start)

    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
