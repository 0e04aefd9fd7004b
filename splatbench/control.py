"""The readings that a cell's limits are set from (splatbench/limits/).

    python3 splatbench/control.py --workload <cell> --seeds 11,12,... \
        [--control-seeds 21,22,23] [--faults half_batch,...] [--seconds S]

One process, one JSON line a reading on standard output:

  program  a run of the cell (run.py's own path, --trace 0, a window of
           `--seconds`) on each of `--seeds`: the numbers it compares;
  control  the reference computed in bfloat16 put in the program's place
           (every per-splat and per-fragment quantity; α's clamp, the sums,
           the image and the loss in float32 or more; parameters in
           float32), against the reference, on each of `--control-seeds`;
  <fault>  a run with that fault planted in the timed path, on each of
           `--control-seeds`: `state_unchanged` (a train step that updates
           nothing), `half_batch` (the loss over half of the image),
           `altered_answer` (a frame with one value changed), `stale_frame`
           (a frame returned for the pose before), `stats_lost` (a train
           step whose binning counters never reach the runner),
           `stats_stale` (a frame's counters held from an earlier frame).

The benchmark's own runs never run this. A limit lies above the largest
program reading and below the smallest control or fault reading (PERF.md).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "splatbench":
    sys.path[0] = str(ROOT)


def control_numbers(workload: str, seed: int, device, root: Path = ROOT, overrides=None) -> dict:
    """The cell's compared numbers with the bfloat16 control in the
    program's place."""
    import torch

    from splatbench import run, scene
    from splatbench.runners import train, view

    _, cfg, tr, _ = run.resolve(root, run.load_benchmark(root), workload)
    cfg = {**cfg, **(overrides or {})}
    cams = scene.cameras(cfg, tr["cameras"])
    if tr["runner"] == "view":
        poses = view.sample_poses(seed, range(len(cams)), tr["sample_poses"])
        want, _ = view.reference_frames(cfg, tr, seed, device, cams, poses, torch.float64)
        got, _ = view.reference_frames(cfg, tr, seed, device, cams, poses, torch.bfloat16)
        return view.compare(got, want)
    targets = scene.make_targets(cfg, seed, device, len(cams))
    views = [int(v) for v in scene.view_sequence(seed, len(cams), tr["checked_steps"])]
    want = train.reference_run(cfg, tr, seed, device, cams, targets, views, torch.float64,
                               torch.float64, False)
    got = train.reference_run(cfg, tr, seed, device, cams, targets, views, torch.bfloat16,
                              torch.float32, False)
    return train.compare(got, want)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)

    from splatbench import run

    run.cache_env(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")

    def emit(kind, seed, numbers, t):
        print(json.dumps({"kind": kind, "seed": seed, "numbers": numbers,
                          "seconds": time.perf_counter() - t}), flush=True)

    def ints(text):
        return [int(s) for s in text.split(",") if s]

    for seed in ints(args.seeds):
        t = time.perf_counter()
        line = run.run_cell(args.workload, seed, args.seconds, False, t0=t)
        emit("program", seed, {k: c["value"] for k, c in line["checks"].items()}, t)
    for seed in ints(args.control_seeds):
        t = time.perf_counter()
        emit("control", seed, control_numbers(args.workload, seed, dev), t)
        for fault in [f for f in args.faults.split(",") if f]:
            t = time.perf_counter()
            line = run.run_cell(args.workload, seed, args.seconds, False, fault=fault, t0=t)
            emit(fault, seed, {k: c["value"] for k, c in line["checks"].items()}, t)
    return 0


if __name__ == "__main__":
    sys.exit(main())
