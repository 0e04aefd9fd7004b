"""Command-line interface of the port.

Subcommands:
  render     — render a PLY scene to a PNG from an orbit pose
  view       — serve the interactive HTTP viewer for a PLY scene
  train      — fit a scene to a target image
  turntable  — render an orbit to PNG frames
  validate   — cross-check the fast backends against the oracle
  info       — print scene statistics for a PLY

Usage: python -m gaussian_splat_tpu_torch.cli <subcommand> [options]

Everything runs on the GPU unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading

from gaussian_splat_tpu_torch.config import BACKENDS


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help='torch device; default: the GPU (fails without one). '
                        'Pass "cpu" to run on the CPU.')


def _add_render_config_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--backend", default="auto", choices=list(BACKENDS))
    p.add_argument("--tile-width", type=int, default=32)
    p.add_argument("--tile-height", type=int, default=16)
    p.add_argument("--sh-degree", type=int, default=3)
    p.add_argument("--background", type=float, nargs=3, default=[0.0, 0.0, 0.0])
    p.add_argument("--pairs-per-gaussian", type=float, default=4.0)
    p.add_argument("--antialiased", action="store_true",
                   help="antialiased mode (opacity compensation)")
    p.add_argument("--no-sat-check", action="store_true",
                   help="disable the kernel's early-saturation exit: exact "
                        "tau=0 compositing")
    _add_aabb_clip_arg(p)
    _add_device_arg(p)


def _add_aabb_clip_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--aabb-clip", type=float, default=None,
                   help="drop splats with any |coord| >= R (the original "
                        "viewer clips at 5)")


def _render_config(args):
    from gaussian_splat_tpu_torch.config import RenderConfig

    return RenderConfig(
        backend=args.backend,
        tile_width=args.tile_width,
        tile_height=args.tile_height,
        sh_degree=args.sh_degree,
        background=tuple(args.background),
        pairs_per_gaussian=args.pairs_per_gaussian,
        antialiased=args.antialiased,
        sat_check=not args.no_sat_check,
    )


def _load_model(args):
    from gaussian_splat_tpu_torch.io.ply import load_gaussians

    model = load_gaussians(args.ply, device=args.device)
    if args.aabb_clip:
        model = model.aabb_filter(args.aabb_clip)
    return model


def cmd_render(args) -> int:
    import torch
    from PIL import Image

    from gaussian_splat_tpu_torch.camera import orbit_camera
    from gaussian_splat_tpu_torch.ops.render import render
    from gaussian_splat_tpu_torch.viewer.viewer import to_uint8

    model = _load_model(args)
    cam = orbit_camera(
        args.radius, args.azimuth, args.elevation,
        width=args.width, height=args.height, device=model.device,
    )
    with torch.no_grad():
        out = render(model, cam, _render_config(args))
    Image.fromarray(to_uint8(out.image)).save(args.out)
    print(f"rendered {model.num_gaussians} splats on {model.device} -> {args.out}")
    return 0


def cmd_view(args) -> int:
    from gaussian_splat_tpu_torch.viewer.viewer import Viewer

    model = _load_model(args)
    viewer = Viewer(
        model,
        _render_config(args),
        width=args.width,
        height=args.height,
        show_overlay=not args.no_overlay,
        hot_reload=args.hot_reload,
        lod_fraction=args.lod,
        lod_pair_budget=args.lod_pairs,
        device=model.device,
    )
    server = viewer.serve(host=args.host, port=args.port, block=False)
    # printed once the socket listens: a client that waits for this line can
    # connect at once
    print(f"serving {model.num_gaussians} splats on {model.device} at "
          f"http://{args.host}:{server.server_address[1]}/", flush=True)
    try:
        threading.Event().wait()  # until the process is interrupted
    finally:
        server.shutdown()
        server.server_close()
    return 0


def cmd_train(args) -> int:
    import numpy as np
    import torch
    from PIL import Image

    from gaussian_splat_tpu_torch.camera import orbit_camera
    from gaussian_splat_tpu_torch.config import TrainConfig
    from gaussian_splat_tpu_torch.io.ply import save_gaussians
    from gaussian_splat_tpu_torch.train.trainer import fit

    model = _load_model(args)
    target = np.asarray(Image.open(args.target).convert("RGB"), np.float32) / 255.0
    cam = orbit_camera(
        args.radius, args.azimuth, args.elevation,
        width=target.shape[1], height=target.shape[0], device=model.device,
    )
    tc = TrainConfig(num_steps=args.steps, checkpoint_dir=args.checkpoint_dir)
    fitted, history = fit(
        model, cam, torch.from_numpy(target), _render_config(args), tc,
        callback=lambda i, l, s: print(f"step {i}: loss {l:.5f}"),
    )
    save_gaussians(args.out, fitted)
    print(f"trained {args.steps} steps on {model.device}, "
          f"final loss {history[-1]:.5f} -> {args.out}")
    return 0


def cmd_turntable(args) -> int:
    from gaussian_splat_tpu_torch.viewer.viewer import Viewer

    model = _load_model(args)
    viewer = Viewer(
        model, _render_config(args), width=args.width, height=args.height,
        show_overlay=False, device=model.device,
    )
    viewer.orbit_turntable(
        n_frames=args.frames,
        radius=args.radius,
        elevation_deg=args.elevation,
        out_dir=args.out_dir,
    )
    print(f"wrote {args.frames} frames to {args.out_dir}/")
    return 0


def cmd_validate(args) -> int:
    """Cross-check the fast backends against the oracle on a small crop of
    the scene. On the GPU: "torch_tile" (plain torch) and "cuda" (the
    kernels); on the CPU "cuda" cannot run and is reported as skipped."""
    import dataclasses

    import numpy as np
    import torch

    from gaussian_splat_tpu_torch.camera import orbit_camera
    from gaussian_splat_tpu_torch.ops.render import render

    model = _load_model(args)
    if model.num_gaussians > args.sample:
        idx = np.random.default_rng(0).choice(
            model.num_gaussians, args.sample, replace=False
        )
        model = model._take_host(idx)
    cam = orbit_camera(args.radius, 30.0, 20.0, width=160, height=120,
                       device=model.device)
    cfg = _render_config(args)
    ok = True
    with torch.no_grad():
        ref = render(model, cam, dataclasses.replace(cfg, backend="reference")).image
        for be in ["torch_tile", "cuda"]:
            if be == "cuda" and model.device.type != "cuda":
                print(f"SKIP {be:<10} needs a CUDA device (running on {model.device})")
                continue
            img = render(model, cam, dataclasses.replace(cfg, backend=be)).image
            err = float((img - ref).abs().max())
            status = "OK " if err < args.tol else "FAIL"
            ok &= err < args.tol
            print(f"{status} {be:<10} max|Δ| vs oracle = {err:.2e} (tol {args.tol:.0e})")
    return 0 if ok else 1


def cmd_info(args) -> int:
    model = _load_model(args)
    means = model.means.detach()
    stats = {
        "num_gaussians": model.num_gaussians,
        "sh_degree": model.sh_degree,
        "means_min": means.min(0).values.tolist(),
        "means_max": means.max(0).values.tolist(),
        "opacity_mean": float(model.opacities.detach().mean()),
        "scale_mean": float(model.scales.detach().mean()),
    }
    print(json.dumps(stats, indent=2))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gaussian_splat_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render a PLY to a PNG")
    p.add_argument("ply")
    p.add_argument("--out", default="render.png")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--radius", type=float, default=5.0)
    p.add_argument("--azimuth", type=float, default=0.0)
    p.add_argument("--elevation", type=float, default=20.0)
    _add_render_config_args(p)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("view", help="interactive HTTP viewer")
    p.add_argument("ply")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--no-overlay", action="store_true",
                   help="disable the grid/axes overlay (toggle live with 'g')")
    p.add_argument("--lod", type=float, default=0.0,
                   help="render the top-LOD fraction of splats while the "
                        "camera is being dragged (0 = always full model)")
    p.add_argument("--lod-pairs", type=float, default=0.0,
                   help="pair-budget-aware drag LoD: bound the dragged "
                        "frame's tile-pair cost to this fraction of the "
                        "full frame's (takes precedence over --lod)")
    p.add_argument("--hot-reload", action="store_true",
                   help="poll the CUDA sources (csrc/) every frame and "
                        "hot-swap rebuilt kernels, keeping the last good build")
    _add_render_config_args(p)
    p.set_defaults(fn=cmd_view)

    p = sub.add_parser("train", help="fit a scene to a target image")
    p.add_argument("ply")
    p.add_argument("--target", required=True, help="target image (PNG/JPEG)")
    p.add_argument("--out", default="trained.ply")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--radius", type=float, default=5.0)
    p.add_argument("--azimuth", type=float, default=0.0)
    p.add_argument("--elevation", type=float, default=20.0)
    p.add_argument("--checkpoint-dir", default=None)
    _add_render_config_args(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("turntable", help="render an orbit to PNG frames")
    p.add_argument("ply")
    p.add_argument("--out-dir", default="turntable")
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--radius", type=float, default=5.0)
    p.add_argument("--elevation", type=float, default=20.0)
    _add_render_config_args(p)
    p.set_defaults(fn=cmd_turntable)

    p = sub.add_parser("validate", help="cross-check backends vs the oracle")
    p.add_argument("ply")
    p.add_argument("--sample", type=int, default=2000,
                   help="subsample to this many splats (oracle is O(N·H·W))")
    p.add_argument("--radius", type=float, default=5.0)
    p.add_argument("--tol", type=float, default=1e-3)
    _add_render_config_args(p)
    p.set_defaults(fn=cmd_validate)

    p = sub.add_parser("info", help="scene statistics")
    p.add_argument("ply")
    _add_aabb_clip_arg(p)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
