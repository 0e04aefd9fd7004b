"""Run one cell of the benchmark once, on the machine it is started on.

    python3 splatbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name from BENCHMARK.json: the cell's
configuration file (its `file`), its traffic mix splatbench/traffic/<mix>.json
(which names the runner in splatbench/runners/ that drives it), its limits
splatbench/limits/<cell>.json, and each per-layer metric's reader
splatbench/metrics/<metric>.py. Adding a configuration, a mix, a cell or a
per-layer metric adds files and entries; no file here changes.

The last line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (with --trace 0 the cell's end-to-end metrics, with
--trace 1 its per-layer metrics), `device`, with --trace 1 `breakdown`, and
last `checks`, each compared number with its limit; the same numbers are the
last lines of standard error. Without a CUDA card, or with fewer cards than
the cell asks for, it prints no result and exits with code 2; if JAX or the
JAX package was loaded it exits with code 3.
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# run as a script, this folder leads sys.path, where its modules would shadow
# top-level ones of the same name: the checkout's root takes its place
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "splatbench":
    sys.path[0] = str(ROOT)

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "gaussian_splat_tpu")
CACHE = ".bench_cache"


def cache_env(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    base = root / CACHE
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(base / sub)


def load_benchmark(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def resolve(root: Path, bench: dict, workload: str):
    """(cell, config, traffic, limits) of the cell named `workload`."""
    from splatbench.runners.common import load_json

    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(root / config["file"])
    traffic = load_json(root / "splatbench" / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(root / "splatbench" / "limits" / f"{workload}.json")
    return cell, cfg, traffic, limits


def applies(metric: dict, cell: str, reported) -> bool:
    """Whether `metric` belongs in `cell`'s result line: its `workloads`
    list, else every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def end_to_end(bench: dict, cell: str) -> list:
    return [m for m in bench["end_to_end"] if applies(m, cell, ())]


def per_layer(bench: dict, cell: str) -> list:
    reported = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"] if applies(m, cell, reported)]


def reader(root: Path, name: str):
    path = root / "splatbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"splatbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_loaded() -> list:
    """Top-level names of loaded modules that the port must never load,
    compared whole (gaussian_splat_tpu_torch is not gaussian_splat_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count()}


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read: {e}"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device=None,
             root: Path = ROOT, overrides=None, fault=None, t0: float = T0) -> dict:
    """One run of one cell; returns the result line's object. `overrides`
    (a dict merged into the configuration) and `fault` serve the harness's
    own tests only."""
    import torch

    from splatbench.runners.common import Context

    bench = load_benchmark(root)
    cell, cfg, traffic, limits = resolve(root, bench, workload)
    if overrides:
        cfg = {**cfg, **overrides}
    device = torch.device(device or "cuda")
    runner = importlib.import_module(f"splatbench.runners.{traffic['runner']}")
    ctx = Context(cell=cell, cfg=cfg, traffic=traffic, limits=limits, seed=seed,
                  seconds=seconds, trace=trace, device=device, t0=t0, fault=fault)
    outcome = runner.run(ctx)
    bad = forbidden_loaded()
    if bad:
        raise ForbiddenModules(bad)

    if trace:
        metrics = {}
        for m in per_layer(bench, workload):
            value = reader(root, m["name"]).read(outcome.readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": outcome.e2e[m["name"]], "unit": m["unit"]}
                   for m in end_to_end(bench, workload)}
    dev = {**card(device), "count": cell["chips"],
           "memory_peak_bytes": outcome.memory_peak_bytes}
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"], dev["window_s"] = outcome.busy_s, outcome.window_s
        line["breakdown"] = outcome.breakdown
    line["checks"] = outcome.checks
    print(json.dumps({"setup_parts_s": outcome.setup_parts}), file=sys.stderr)
    return line


class ForbiddenModules(RuntimeError):
    pass


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cache_env(ROOT)
    bench = load_benchmark(ROOT)
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except ForbiddenModules as e:
        print(f"loaded modules the benchmark must not load: {e.args[0]}", file=sys.stderr)
        return 3
    print(json.dumps({"card": power_limit(), "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
