"""The backward's reduction at the bench shape on one GPU: the rank_perm
kernel against its plain version and the rank sort, both kernels against
another checkout's, segsum also against edited copies of its source, and
the host's time to issue each wrapper's launch.

    python3 scripts/torch_segsum_sweep.py [--other ROOT] [--source FILE ...]
        [--out FILE]

Builds the bench scene of chip_smoke.py (1M splats, 1920x1080), its binning
and the backward kernel's gradient rows under seeded unit-scale cotangents,
as chip_smoke.py's `kernels` phase does, and chip_smoke's ragged full-size
segments. Then:

  * rank_perm (`cuda_raster.rank_permutation_from_sort`), its plain version
    (`binning.rank_permutation_by_mask`), the rank sort
    (`tile_raster.rank_permutation`) and one stable `torch.sort`, checked
    equal where they compute the same permutation;
  * rank_perm as the package builds it and --other ROOT's
    csrc/rank_perm.cu (either C interface: the package's, which reads
    binning's kept cells, or the slot-scratch design's, which reads
    pair_gauss and takes one int of scratch a slot), in turns: other,
    package, package, other, each equal to the rank sort and bitwise over
    two calls, with its device time also by kernel and with the L2 flushed
    before each call (`cold_by_kernel`: the backward finds its inputs cold,
    after raster_bwd's 290 MB);
  * segsum as the package builds it, each --source FILE (a copy of
    csrc/segsum.cu with other settings) and --other ROOT's csrc/segsum.cu
    (both with the package's C interface), in turns: other, package,
    sources, package, other.
    Each is checked within chip_smoke's gradient tolerance of the plain
    version, bitwise over two calls, and run on both inputs;
  * the host's microseconds per call of the segsum and rank_perm wrappers
    and of the pieces of a launch (allocation, stream, device scope, checks).

Device times three ways: one call per event pair (`ms`, the host's time to
issue the call included, chip_smoke's `kernel_ms`), 20 calls back to back
(`ms_back_to_back`), and the device's own time by the profiler (`device_ms`;
for the permutation also split by kernel). Prints one JSON object per line,
the card's name and power limit first, and with --out also writes them all
to FILE. Needs one NVIDIA GPU.
"""

import argparse
import ctypes
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (exits with code 2 when there is no GPU)
from gaussian_splat_tpu_torch import RenderConfig, _build, calibrate_render_config  # noqa: E402
from gaussian_splat_tpu_torch.ops import binning as binning_ops  # noqa: E402
from gaussian_splat_tpu_torch.ops import cuda_raster, tile_raster  # noqa: E402
from gaussian_splat_tpu_torch.ops.binning import rank_permutation_by_mask  # noqa: E402
from gaussian_splat_tpu_torch.utils import roofline  # noqa: E402

REPS = 20
L2_FLUSH_BYTES = 128 << 20  # written before a call to find the 50 MB L2 cold
HOST_CALLS = 200  # wrapper calls timed on the host's clock, then one sync


def emit(lines, **fields):
    print(json.dumps(fields), flush=True)
    lines.append(fields)


def bench_rows():
    """(rows, binning, config, n, pairs) of the bench frame's backward."""
    model, camera = chip_smoke.bench_scene()
    config = calibrate_render_config(model, camera, RenderConfig())
    w, h = camera.width, camera.height
    _, binning, args = chip_smoke.raster_inputs(model, camera, config)
    walked = torch.zeros_like(args[3])
    rgbd, t_final = cuda_raster.raster_forward(*args, w, h, config, walked=walked)
    gen = torch.Generator(device="cuda").manual_seed(7)
    d_rgbd = torch.randn((h, w, 4), generator=gen, device="cuda")
    d_t = torch.randn((h, w), generator=gen, device="cuda")
    rows = cuda_raster.raster_backward(
        *args, rgbd, t_final, d_rgbd, d_t, w, h, config, walked=walked)
    pairs = int(binning.num_pairs) - int(binning.overflow)
    return rows, binning, config, model.num_gaussians, pairs


def build(src, workdir, kernel, argtypes=None):
    """(<kernel>_launch of one source built with the package's flags and
    the package's C interface or `argtypes`, the compiler's register and
    spill lines)."""
    name = f"{src.parent.parent.parent.name}-{src.stem}-{len(os.listdir(workdir))}.so"
    lib = pathlib.Path(workdir) / name
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
    done = subprocess.run(cmd, check=True, capture_output=True, text=True)
    fn = getattr(ctypes.CDLL(str(lib)), f"{kernel}_launch")
    fn.argtypes = argtypes or cuda_raster._ARGTYPES[kernel]
    fn.restype = ctypes.c_int
    report = [line.strip() for line in (done.stdout + done.stderr).splitlines()
              if "registers" in line or "spill" in line]
    return fn, report


def timings(fn):
    return {"ms": chip_smoke.time_ms(fn, REPS),
            "ms_back_to_back": chip_smoke.time_back_to_back_ms(fn, REPS),
            "device_ms": chip_smoke.device_ms(fn)}


def device_ms_by_kernel(fn, calls=5):
    """{device activity name: ms per call} of fn(), by the profiler."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name[:60]
            by[name] = by.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / calls
    return dict(sorted(by.items(), key=lambda kv: -kv[1]))


def rank_perm_turns(lines, smi, opts, workdir, sort_args, pair_gauss, sorted_perm, bound):
    """rank_perm of the package and of --other, in turns: other, package,
    package, other."""
    pair_src, rank_starts, kept, config = sort_args
    n, num_rows = rank_starts.shape[0] - 1, pair_src.shape[0]
    emission = binning_ops.emission_rows(n, config)
    # enough scratch for either design: one int a slot or the records
    scratch = -(-max(emission.slots, 2 * emission.mask_words) // 4) * 4
    flush = torch.empty((L2_FLUSH_BYTES // 4,), dtype=torch.int32, device="cuda")

    def built(src):
        slot_scratch = "kept_small" not in src.read_text()  # the slot-scratch design
        argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn, _ = build(src, workdir, "rank_perm", argtypes if slot_scratch else None)
        inputs = ((pair_gauss, rank_starts) if slot_scratch
                  else (kept.small, kept.big, kept.big_ranks, rank_starts))

        def go():
            buf = torch.empty((scratch + num_rows,), dtype=torch.int32, device="cuda")
            err = fn(pair_src.data_ptr(), *(x.data_ptr() for x in inputs), buf.data_ptr(),
                     buf[scratch:].data_ptr(), n, num_rows, emission.k_small, emission.k_big,
                     emission.big, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"rank_perm launch failed: CUDA error {err}")
            return buf[scratch:]
        return go

    package = ("package", lambda: cuda_raster.rank_permutation_from_sort(*sort_args))
    turns = [package, package]
    if opts.other:
        other_src = pathlib.Path(opts.other) / "gaussian_splat_tpu_torch" / "csrc" / "rank_perm.cu"
        other = ("other", built(other_src.resolve()))
        turns = [other, *turns, other]
    for name, go in turns:
        got, again = go(), go()
        t = timings(go)
        emit(lines, what="rank_perm_turn", design=name, gpu=smi,
             equals_rank_sort=bool(torch.equal(got, sorted_perm)),
             bitwise_repeatable=bool(torch.equal(got, again)), **t, bound_ms=bound,
             share_of_bound=bound / t["ms"],
             share_of_bound_device=bound / t["device_ms"] if t["device_ms"] else None,
             by_kernel=device_ms_by_kernel(go),
             cold_by_kernel=device_ms_by_kernel(lambda: (flush.zero_(), go())))


def host_us(fn, calls=HOST_CALLS):
    """Median over 5 rounds of the host's microseconds per call of fn(),
    `calls` calls then one synchronisation (outside the clock)."""
    fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        rounds.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return sorted(rounds)[2]


def host_pieces(rows, perm, rank_starts, n):
    """The host's microseconds of the pieces of one segsum launch."""
    dev = rows.device
    launch = cuda_raster._launcher("segsum")
    out = torch.empty((n, cuda_raster.ROW_COLS), device=dev)
    raw = cuda_raster._stream(dev)

    def bare():
        launch(rows.data_ptr(), perm.data_ptr(), rank_starts.data_ptr(), out.data_ptr(),
               n, rows.shape[0], raw)

    def device_scope():
        with torch.cuda.device(dev):
            pass

    def on_scope():
        with cuda_raster._on(dev):
            pass

    return {
        "ctypes_launch_us": host_us(bare),
        "torch_empty_us": host_us(lambda: torch.empty((n, cuda_raster.ROW_COLS), device=dev)),
        "stream_object_us": host_us(lambda: torch.cuda.current_stream().cuda_stream),
        "raw_stream_us": host_us(lambda: cuda_raster._stream(dev)),
        "torch_cuda_device_scope_us": host_us(device_scope),
        "on_scope_us": host_us(on_scope),
        "three_checks_us": host_us(lambda: (
            cuda_raster._check("rows", rows, torch.float32, (rows.shape[0], cuda_raster.ROW_COLS)),
            cuda_raster._check("perm", perm, torch.int32, (rows.shape[0],), rows),
            cuda_raster._check("rank_starts", rank_starts, torch.int32, (n + 1,), rows))),
        "launcher_lookup_us": host_us(lambda: cuda_raster._launcher("segsum")),
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--other", help="root of another checkout whose segsum to time")
    parser.add_argument("--source", nargs="*", default=[],
                        help="edited copies of csrc/segsum.cu to time beside it")
    parser.add_argument("--out", help="also write every line, as one JSON list, here")
    opts = parser.parse_args()
    lines = []
    smi = chip_smoke.phase_env()
    _build.build_all()
    rows, binning, config, n, pairs = bench_rows()
    rank_starts, pair_gauss = binning.rank_starts, binning.pair_gauss

    # -- the permutation ---------------------------------------------------
    kept = binning.kept
    sort_args = (binning.pair_src, rank_starts, kept, config)

    def rank_perm():
        return cuda_raster.rank_permutation_from_sort(*sort_args)

    perm = rank_perm()
    sorted_perm = tile_raster.rank_permutation(pair_gauss, rank_starts, n)
    bound = roofline.rank_perm_cost(n, pairs, rows.shape[0], kept.small.numel() + kept.big.numel(),
                                    kept.big_ranks.numel()).attainable_ms()
    keyed = torch.where(torch.arange(rows.shape[0], device="cuda") < pairs, pair_gauss, n)
    emit(lines, what="rank_perm", gpu=smi, n_splats=n, pairs=pairs, rows=rows.shape[0],
         equals_rank_sort=bool(torch.equal(perm, sorted_perm)),
         plain_equals_rank_sort=bool(torch.equal(
             rank_permutation_by_mask(*sort_args), sorted_perm)),
         bound_ms=bound, kernel=timings(rank_perm), host_us=host_us(rank_perm),
         plain=timings(lambda: rank_permutation_by_mask(*sort_args)),
         kernel_by_kernel=device_ms_by_kernel(rank_perm),
         rank_sort=timings(lambda: tile_raster.rank_permutation(pair_gauss, rank_starts, n)),
         torch_sort=timings(lambda: torch.sort(keyed, stable=True)))

    # -- segsum, in turns, on the bench rows and on ragged segments ----------
    ragged = chip_smoke.ragged_segments()
    inputs = {"bench_full": (rows, perm, rank_starts, n, pairs),
              "ragged_full": (*ragged[:4], int(ragged[2][-1]))}
    emit(lines, what="segsum_host", gpu=smi,
         wrapper_us=host_us(lambda: cuda_raster.segment_sum(rows, perm, rank_starts, n)),
         **host_pieces(rows, perm, rank_starts, n))

    def call(fn, case):
        """One launch of a built segsum on `case`."""
        r, p, s, nn, _ = inputs[case]

        def go():
            out = torch.empty((nn, cuda_raster.ROW_COLS), device="cuda")
            err = fn(r.data_ptr(), p.data_ptr(), s.data_ptr(), out.data_ptr(), nn, r.shape[0],
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"segsum launch failed: CUDA error {err}")
            return out
        return go

    with tempfile.TemporaryDirectory() as workdir:
        rank_perm_turns(lines, smi, opts, workdir, sort_args, pair_gauss, sorted_perm, bound)
        # (name, built launch function or None for the package's wrapper)
        package = ("package", None)
        turns = [package]
        for src in opts.source:
            fn, report = build(pathlib.Path(src).resolve(), workdir, "segsum")
            emit(lines, what="segsum_build", design=src, ptxas=report)
            turns.append((src, fn))
        turns.append(package)
        if opts.other:
            other_src = pathlib.Path(opts.other) / "gaussian_splat_tpu_torch" / "csrc" / "segsum.cu"
            other = ("other", build(other_src.resolve(), workdir, "segsum")[0])
            turns = [other, *turns, other]
        for case, (r, p, s, nn, real) in inputs.items():
            want = tile_raster.segment_sum_torch(r, p, s, nn)
            bound = roofline.segsum_cost(nn, real).attainable_ms()
            for name, fn in turns:
                if fn is None:
                    def go(r=r, p=p, s=s, nn=nn):
                        return cuda_raster.segment_sum(r, p, s, nn)
                else:
                    go = call(fn, case)
                got, again = go(), go()
                err, over = chip_smoke.grad_errors(got, want)
                t = timings(go)
                emit(lines, what="segsum", case=case, design=name, max_abs_err=err,
                     n_over=over, bitwise_repeatable=bool(torch.equal(got, again)), **t,
                     bound_ms=bound, share_of_bound=bound / t["ms"],
                     share_of_bound_device=bound / t["device_ms"] if t["device_ms"] else None)
    if opts.out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
        with open(opts.out, "w") as f:
            json.dump(lines, f, indent=1)


if __name__ == "__main__":
    main()
