"""Are two checkouts' `raster_fwd` kernels bitwise the same function, and as fast?

    python3 scripts/torch_raster_fwd_bits.py dump --root CHECKOUT --out FILE
    python3 scripts/torch_raster_fwd_bits.py compare FILE_A FILE_B

`dump` imports `chip_smoke` and `gaussian_splat_tpu_torch` from CHECKOUT (any
checkout of this repo that has the PyTorch/CUDA port), builds that checkout's
kernel, runs it on chip_smoke's small scenes and on the full-size bench scene
(1M splats, 1920x1080) and saves r, g, b, depth, T_final and `walked` of every
case. `compare` holds two such files against each other with `torch.equal`,
case by case over the cases both have, and exits non-zero on any difference.
A change that alters no pixel's arithmetic (a thread layout, a cull) must
leave every case bitwise equal. `dump` also times the kernel on the full-size
case, as chip_smoke.py does (`kernel_ms`: the median of 21 calls, one call per
CUDA event pair, the host's issue time included; `kernel_ms_back_to_back`: 20
calls between two events, median of 5), and `compare` prints both files'
times beside each other. Needs one NVIDIA GPU for `dump`; run each dump in its
own process, since both checkouts' packages have the same name; to compare
times, alternate the two checkouts' dumps on one machine and one card.
"""

import argparse
import os
import sys

import torch


def dump(root, out):
    sys.path.insert(0, os.path.abspath(root))
    import chip_smoke  # exits with code 2 when there is no GPU
    from gaussian_splat_tpu_torch import RenderConfig, calibrate_render_config
    from gaussian_splat_tpu_torch.ops import cuda_raster

    model, camera = chip_smoke.bench_scene()
    config = calibrate_render_config(model, camera, RenderConfig())
    scenes = [*chip_smoke.small_scenes(), ("bench_full", model, camera, config)]
    result = {}
    for name, m, cam, cfg, *rest in scenes:
        _, _, args = chip_smoke.raster_inputs(m, cam, cfg)
        if rest and rest[0] is not None:
            args = (rest[0](args[0]), *args[1:])
        walked = torch.zeros_like(args[3])
        rgbd, t_final = cuda_raster.raster_forward(
            *args, cam.width, cam.height, cfg, walked=walked)
        torch.cuda.synchronize()
        result[name] = {"rgbd": rgbd.cpu(), "t_final": t_final.cpu(), "walked": walked.cpu()}
        print(f"{name}: walked {int(walked.sum())} pairs", flush=True)
        if name == "bench_full":
            def launch():
                cuda_raster.raster_forward(*args, cam.width, cam.height, cfg)

            timing = {"root": os.path.abspath(root),
                      "kernel_ms": chip_smoke.time_ms(launch, 21),
                      "kernel_ms_back_to_back": chip_smoke.time_back_to_back_ms(launch, 5)}
            print(f"bench_full: {timing}", flush=True)
    torch.save({"cases": result, "timing": timing}, out)


def compare(path_a, path_b):
    files = [torch.load(path_a), torch.load(path_b)]
    for path, f in zip((path_a, path_b), files):
        print(f"{path}: {f['timing']}")
    a, b = (f["cases"] for f in files)
    shared = [name for name in a if name in b]
    if not shared:
        sys.exit("no case in common")
    differ = 0
    for name in shared:
        same = {k: torch.equal(a[name][k], b[name][k]) for k in a[name]}
        print(f"{name}: " + ", ".join(
            f"{k} {'bitwise equal' if ok else 'DIFFERS'}" for k, ok in same.items()))
        differ += not all(same.values())
    only = sorted(set(a) ^ set(b))
    if only:
        print(f"in one file only, not compared: {only}")
    sys.exit(1 if differ else 0)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="command", required=True)
    d = sub.add_parser("dump")
    d.add_argument("--root", required=True)
    d.add_argument("--out", required=True)
    c = sub.add_parser("compare")
    c.add_argument("files", nargs=2)
    opts = parser.parse_args()
    if opts.command == "dump":
        dump(opts.root, opts.out)
    else:
        compare(*opts.files)


if __name__ == "__main__":
    main()
