"""The readings that the limits of a cell driven by the `train_sharded`
runner are set from: control.py's readings, with the control computed over
the cell's ranks (control.py's one-process reference does not fit there).

    python3 splatbench/control_sharded.py --workload <cell> --seeds 11,12,... \
        [--control-seeds 21,22,23] [--faults half_batch,...] [--seconds S]

One JSON line a reading on standard output, in control.py's form:
`program` (a run of the cell on each of `--seeds`), `control` (the
reference in bfloat16 against the reference in float64, both over the
cell's ranks, splatbench/reference/train_sharded.py) and each planted fault
on each of `--control-seeds`: control.py's `half_batch`, `state_unchanged`
and `stats_lost`, and `no_reduce` (each rank keeps its own band's gradient
of the records instead of the reduce-scatter's sum over the bands). The
benchmark's own runs never run this.
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


def _join(rank: int, job: dict):
    """(group, host group, device): a process group of the cell's ranks made
    with torch.distributed alone (the control runs nothing of the program)."""
    import torch
    import torch.distributed as dist

    backend = "nccl" if job["device"] == "cuda" else "gloo"
    dev = torch.device(job["device"], rank) if job["device"] == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=job["init"], world_size=job["ranks"],
                            rank=rank)
    return dist.group.WORLD, dist.new_group(backend="gloo"), dev


def control_rank(rank: int, job: dict, ctx):
    """Both references on this rank's rows; rank 0 returns the numbers."""
    import torch
    import torch.distributed as dist

    from splatbench import scene
    from splatbench.reference import train_sharded as ref
    from splatbench.runners import train, train_sharded

    group, host, dev = _join(rank, job)
    cfg, tr, seed = job["cfg"], job["traffic"], job["seed"]
    per = cfg["N"] // job["ranks"]
    start = scene.make_splats(cfg, seed, dev, rows=(rank * per, (rank + 1) * per))
    cams = scene.cameras(cfg, tr["cameras"])
    targets = scene.make_targets(cfg, seed, dev, len(cams))
    views = [int(v) for v in scene.view_sequence(seed, len(cams), tr["checked_steps"])]
    s = scene.render_settings(cfg, tr)
    out = {}
    for name, dtype, param_dtype in (("want", torch.float64, torch.float64),
                                     ("got", torch.bfloat16, torch.float32)):
        r = ref.train(start, cams, targets, views, s, tr["train"], group, dtype, param_dtype)
        r["change_norms"] = train_sharded.change_norms(r.pop("params"), start, host)
        out[name] = r
    dist.barrier(group=host)
    dist.destroy_process_group()
    return train.compare(out["got"], out["want"]) if rank == 0 else None


def control_numbers(workload: str, seed: int, device, root: Path = ROOT, overrides=None) -> dict:
    """The cell's compared numbers with the bfloat16 control in the
    program's place, over the cell's ranks."""
    import torch

    from splatbench import run
    from splatbench.runners import common, train_sharded

    cell, cfg, tr, limits = run.resolve(root, run.load_benchmark(root), workload)
    ctx = common.Context(cell=cell, cfg={**cfg, **(overrides or {})}, traffic=tr,
                         limits=limits, seed=seed, seconds=0.0, trace=False,
                         device=torch.device(device), t0=time.perf_counter())
    return train_sharded.launch(control_rank, train_sharded.job_of(ctx), ctx)


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
        print("needs CUDA cards", file=sys.stderr)
        return 2

    def emit(kind, seed, numbers, t):
        print(json.dumps({"kind": kind, "seed": seed, "numbers": numbers,
                          "seconds": time.perf_counter() - t}), flush=True)

    def ints(text):
        return [int(s) for s in text.split(",") if s]

    def program(seed, fault=None):
        t = time.perf_counter()
        line = run.run_cell(args.workload, seed, args.seconds, False, fault=fault, t0=t)
        emit(fault or "program", seed, {k: c["value"] for k, c in line["checks"].items()}, t)

    for seed in ints(args.seeds):
        program(seed)
    for seed in ints(args.control_seeds):
        t = time.perf_counter()
        emit("control", seed, control_numbers(args.workload, seed, "cuda"), t)
        for fault in [f for f in args.faults.split(",") if f]:
            program(seed, fault)
    return 0


if __name__ == "__main__":
    sys.exit(main())
