"""Runner `view`: one viewer user orbiting a scene, a closed loop.

Each frame calls the program's `Viewer.render_frame(camera)` (overlay off,
no level of detail, mode "color") on the next pose of the configuration's
orbit, and the next frame starts when the last returns its host image. A
frame is timed by the host clock from the call to the returned image.

Correct: after the window, a sample of poses drawn from the seed; the
frame the window returned for each is held against the reference's frame
(splatbench/reference/render.py, float64, the same background and rounding
to uint8): the share of channel values that differ and the largest
difference, beside the binning sentinels (all 0) and one raster_fwd launch a
frame.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from splatbench import costs, devtrace, scene
from splatbench.runners import common


def reference_frames(cfg: dict, tr: dict, seed: int, device, cams, poses, dtype,
                     counts: bool = False):
    """{pose: (H, W, 3) uint8} of the reference (or of the control, with a
    lower `dtype`), and {pose: tile counts} with `counts`."""
    from splatbench.reference import render as ref

    s = scene.render_settings(cfg, tr)
    background = tr["background"]
    leaves = scene.make_splats(cfg, seed, device)
    frames, tile_counts = {}, {}
    with torch.no_grad():
        for p in poses:
            img, c = ref.render(leaves, cams[p], s, dtype, counts=counts, background=background)
            frames[p] = ref.to_uint8(img).cpu().numpy()
            tile_counts[p] = c
            del img
    return frames, tile_counts


def compare(got: dict, want: dict) -> dict:
    """Channel values that differ (per million) and the largest difference,
    in uint8 steps, over the sampled frames."""
    diffs = [np.abs(got[p].astype(np.int16) - want[p].astype(np.int16)) for p in want]
    total = sum(d.size for d in diffs)
    return {
        "mismatch_ppm": 1e6 * sum(int((d > 0).sum()) for d in diffs) / total,
        "max_step": max(int(d.max()) for d in diffs),
    }


def sample_poses(seed: int, rendered, k: int):
    rng = np.random.default_rng(scene.sub_seed(seed, 4))
    pool = sorted(rendered)
    return sorted(int(p) for p in rng.choice(pool, size=min(k, len(pool)), replace=False))


def _faulty(render, fault):
    """The frame call with a planted fault (the harness's own tests)."""
    if fault == "altered_answer":
        def altered(cam):
            frame = render(cam).copy()
            frame[0, 0, 0] = (int(frame[0, 0, 0]) + 128) % 256
            return frame
        return altered
    if fault == "stale_frame":
        held = []

        def stale(cam):
            frame = render(cam)
            held.append(frame)
            return held[-2] if len(held) > 1 else frame
        return stale
    return render


def run(ctx: common.Context) -> common.Outcome:
    from gaussian_splat_tpu_torch.models.gaussians import GaussianModel
    from gaussian_splat_tpu_torch.ops.render import calibrate_render_config
    from gaussian_splat_tpu_torch.viewer.viewer import Viewer

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    ctx.mark("import")
    common.build_kernels(dev)
    ctx.mark("build")
    leaves = scene.make_splats(cfg, ctx.seed, dev)
    n = cfg["N"]
    model = GaussianModel(*(leaves[k] for k in scene.LEAVES))
    del leaves
    cams = scene.cameras(cfg, tr["cameras"])
    pcams = [common.program_camera(c, dev) for c in cams]
    ctx.mark("splats")
    rc = calibrate_render_config(model, pcams, common.render_config(cfg, tr),
                                 **common.calibration(cfg, tr))
    ctx.mark("calibrate")
    viewer = Viewer(model, rc, cfg["width"], cfg["height"], show_overlay=False,
                    background=tuple(tr["background"]), device=dev)
    viewer.mode = "color"
    render = _faulty(viewer.render_frame, ctx.fault)
    for cam in pcams:  # warm-up: one turn of the orbit
        render(cam)
    ctx.mark("warm-up")
    setup_s = common.now() - ctx.t0

    def frame_stats():
        return viewer.last_stats

    if ctx.fault == "stats_stale":  # the counters stop following the frames
        held = viewer.last_stats

        def frame_stats():
            return held

    setup_peak = common.peak_bytes(dev)
    common.peak_reset(dev)
    before = common.launches()
    times, scope_ms, stats, last = [], [], [], {}
    frames = 0
    start = common.now()
    while True:
        pose = frames % len(pcams)
        a = common.now()
        frame = render(pcams[pose])
        b = common.now()
        times.append(b - a)
        scope_ms.append(viewer.timers.stats["frame"].last)
        stats.append(frame_stats())
        last[pose] = frame
        frames += 1
        if b - start >= ctx.seconds:
            break
    window_s = b - start
    window_peak = common.peak_bytes(dev)
    launch_gap = common.launch_gap(before, ("raster_fwd",), frames, dev)
    sentinels = common.tally(stats, frames)
    times_ms = sorted(1e3 * t for t in times)
    p95 = times_ms[max(0, math.ceil(0.95 * len(times_ms)) - 1)]

    poses = sample_poses(ctx.seed, last, tr["sample_poses"])
    readings = {
        "n": n, "frames": frames, "frame_ms_mean": 1e3 * window_s / frames,
        "post_render_ms": sum(1e3 * t - s for t, s in zip(times, scope_ms)) / frames,
        "pairs_per_splat": sentinels["num_pairs_mean"] / n,
    }
    busy_s = trace_window = breakdown = None
    if ctx.trace:
        ctx.sync()
        with devtrace.traced(True) as prof:
            a = common.now()
            for _ in range(tr["trace_repeats"]):
                for p in poses:
                    render(pcams[p])
            ctx.sync()
            trace_window = common.now() - a
        busy_ms, _ = devtrace.device_busy(prof)
        busy_s = busy_ms / 1e3
        readings["busy_s"], readings["trace_window_s"] = busy_s, trace_window
        readings["kernel_ms"] = {"raster_fwd": devtrace.kernel_ms(prof, "raster_fwd")}
        breakdown = devtrace.breakdown(prof)
        del prof
    got = {p: last[p] for p in poses}
    memory_peak = max(setup_peak, common.peak_bytes(dev))
    del viewer, model, pcams, render, last, stats, frame_stats
    common.free(dev)

    want, counts = reference_frames(cfg, tr, ctx.seed, dev, cams, poses, torch.float64,
                                    counts=ctx.trace)
    numbers = compare(got, want)
    if ctx.trace:
        w, h = cfg["width"], cfg["height"]
        readings["bound_ms"] = {"raster_fwd": tr["trace_repeats"] * sum(
            costs.kernel_costs(counts[p], n, w, h)["raster_fwd"].attainable_ms() for p in poses)}
        readings["flops_per_frame"] = sum(
            costs.frame_flops(counts[p], n, cfg["sh_degree"], w, h) for p in poses) / len(poses)
    lim = ctx.limits
    checks = {
        "mismatch_ppm": common.check(numbers["mismatch_ppm"], lim["mismatch_ppm"]),
        "max_step": common.check(numbers["max_step"], lim["max_step"]),
        "sentinels": common.check(sum(sentinels[k] for k in common.SENTINELS), 0),
        "stats_missing": common.check(sentinels["missing"], 0),
        "launches_off": common.check(launch_gap, 0),
    }
    return common.Outcome(
        e2e={"setup_s": setup_s, "frame_ms_p95": p95, "frames_per_s": frames / window_s,
             "peak_mem_gib": window_peak / 2 ** 30},
        readings=readings, checks=checks, attempted=frames, failed=0,
        memory_peak_bytes=memory_peak, busy_s=busy_s, window_s=trace_window,
        breakdown=breakdown, setup_parts=ctx.marks,
    )
