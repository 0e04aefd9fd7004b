"""Runner `train_sharded`: the `train` mix with the model split over the
ranks of one host, a closed loop of steps.

run.py runs rank 0 in its own process; this runner starts ranks 1..D−1 (D =
the mix's `ranks`) beside it with `spawn`, one card each. Every rank joins
one process group through the program's `parallel.mesh.make_mesh` (NCCL on
cards; gloo on the CPU, for the harness's tests), makes only its own rows of
the scene (`parallel.mesh.shard_model` over `scene.make_splats` by rows: no
process holds the whole scene), sizes the capacities with the program's
calibration over the whole sharded scene and the cell's cameras
(`calibrate_render_config(mesh=)`), and steps through
`trainer.make_multiview_train_step(dataset, config, TrainConfig(...),
mesh=mesh)`, every rank on the same views. A second process group (gloo, on
the hosts) carries the runner's own traffic: rank 0's decision to end the
window, a step at a time, and what the ranks report at the end.

Times are rank 0's: `setup_s` runs to the barrier that the slowest rank
reaches when it is ready; `step_ms` is the window, closed by a
synchronisation of every card and a barrier, over the steps completed in
it. `peak_mem_gib` is the fullest rank's.

Correct: the reference over the same ranks (splatbench/reference/
train_sharded.py, float64) follows the same first steps from the same rows,
views and targets; compared as in the `train` runner (`loss_gap`,
`grad_gap`, `change_gap`, norms over all rows). Beside them: every band's
binning sentinels over every render, read from the program's counters
(`parallel.sharded_render.counters`, every band's stats gathered on every
rank; `stats_missing` 0 says every render reached them), and one launch of
each kernel's band form a step on every rank.

A rank that dies ends the run within seconds with exit code 2 (rank 0
watches its children, and each child its parent); every collective waits
at most the program's `COLLECTIVE_TIMEOUT`; the children are killed on any
exit of rank 0.
"""

from __future__ import annotations

import dataclasses
import inspect
import multiprocessing
import os
import socket
import sys
import threading
import time

import torch
import torch.distributed as dist

from splatbench import devtrace, exchange_costs, scene
from splatbench.runners import common, train

KERNELS = train.KERNELS
SPANS = ("sharded.exchange", "sharded.exchange_bwd", "sharded.frame_gather")
# lines of the traced run's breakdown: past the one-card cells' ten, so that
# the collectives' kernels (each below the tenth op) show
BREAKDOWN_LINES = 16


def missing_hooks() -> list:
    """What this runner reads of the program and the program lacks."""
    from gaussian_splat_tpu_torch.ops.render import calibrate_render_config
    from gaussian_splat_tpu_torch.parallel import mesh, sharded_render

    need = {
        "parallel.sharded_render.counters": hasattr(sharded_render, "counters"),
        "calibrate_render_config(mesh=)":
            "mesh" in inspect.signature(calibrate_render_config).parameters,
        "shard_model(num_gaussians=)":
            "num_gaussians" in inspect.signature(mesh.shard_model).parameters,
    }
    return [name for name, ok in need.items() if not ok]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- starting the ranks ----------------------------------------------------------


def launch(target, job: dict, ctx: common.Context):
    """`target(rank, job, ctx)` on D ranks: rank 0 here, the others in
    spawned processes. Returns rank 0's result. A child that fails ends
    this process with exit code 2; the children are killed on any exit."""
    spawn = multiprocessing.get_context("spawn")
    children = [spawn.Process(target=_child, args=(target, r, job), daemon=True)
                for r in range(1, job["ranks"])]
    for p in children:
        p.start()
    done = threading.Event()

    def lost():
        return [(i + 1, p.exitcode) for i, p in enumerate(children)
                if p.exitcode not in (None, 0)]

    def give_up(bad):
        print(f"rank(s) ended with exit codes {bad}: the run cannot go on",
              file=sys.stderr, flush=True)
        _kill(children)
        os._exit(2)

    def watch():
        while not done.wait(0.5):
            if lost():
                give_up(lost())

    threading.Thread(target=watch, daemon=True).start()
    try:
        out = target(0, job, ctx)
        for p in children:
            p.join(timeout=120)
        return out
    except Exception:
        # a collective that raised because a rank went away
        for _ in range(20):
            if lost():
                give_up(lost())
            time.sleep(0.25)
        raise
    finally:
        done.set()
        _kill(children)


def _kill(children) -> None:
    for p in children:
        if p.is_alive():
            p.kill()
        p.join(timeout=10)


def _child(target, rank: int, job: dict) -> None:
    parent = os.getppid()

    def orphaned():
        while True:
            time.sleep(1.0)
            if os.getppid() != parent:
                os._exit(3)

    threading.Thread(target=orphaned, daemon=True).start()
    if job["device"] == "cpu":
        torch.set_num_threads(1)
    device = torch.device(job["device"])
    ctx = common.Context(cell=job["cell"], cfg=job["cfg"], traffic=job["traffic"],
                         limits=job["limits"], seed=job["seed"], seconds=job["seconds"],
                         trace=False, device=device, t0=time.perf_counter(),
                         fault=job["fault"])
    target(rank, job, ctx)


def _join(rank: int, job: dict):
    """(mesh, host group, this rank's device): the program's mesh, built
    here; rank 0 builds the kernels first, the others find them built."""
    from gaussian_splat_tpu_torch.parallel.mesh import (
        COLLECTIVE_TIMEOUT, make_mesh, mesh_device,
    )

    if rank == 0:
        common.build_kernels(torch.device(job["device"]))
    mesh = make_mesh(job["ranks"], device=job["device"], rank=rank, init_method=job["init"])
    host = dist.new_group(backend="gloo", timeout=COLLECTIVE_TIMEOUT)
    dev = mesh_device(mesh)
    if rank != 0:
        common.build_kernels(dev)
    if job["fault"] == "rank_lost" and rank == job["ranks"] - 1:
        os._exit(1)
    return mesh, host, dev


def job_of(ctx: common.Context) -> dict:
    ranks = ctx.traffic["ranks"]
    if ctx.device.type == "cuda" and ctx.cell["chips"] != ranks:
        raise ValueError(f"the mix runs {ranks} ranks, the cell asks for {ctx.cell['chips']} cards")
    return dict(cell=ctx.cell, cfg=ctx.cfg, traffic=ctx.traffic, limits=ctx.limits,
                seed=ctx.seed, seconds=ctx.seconds, trace=ctx.trace, fault=ctx.fault,
                ranks=ranks, device=ctx.device.type, init=f"tcp://127.0.0.1:{free_port()}")


# -- a rank's run ----------------------------------------------------------------


def _sum(values, group) -> torch.Tensor:
    """Float64 sums over the ranks of a list of numbers."""
    t = torch.tensor(values, dtype=torch.float64)
    dist.all_reduce(t, group=group)
    return t


def first_grad_norms(optimizer, host) -> dict:
    """Each leaf's first gradient over all rows, from Adam's first moment
    after one step (m = (1 − β1)·g), summed over the ranks."""
    names, sq = [], []
    for group in optimizer.param_groups:
        (p,) = group["params"]
        m = optimizer.state.get(p, {}).get("exp_avg")
        g = 0.0 if m is None else float(
            (m.double() / (1.0 - group["betas"][0])).square().sum())
        names.append(group["name"])
        sq.append(g)
    return dict(zip(names, _sum(sq, host).sqrt().tolist()))


def change_norms(params: dict, start: dict, host) -> dict:
    sq = [float((params[k].detach().double() - start[k].double()).square().sum())
          for k in scene.LEAVES]
    return dict(zip(scene.LEAVES, _sum(sq, host).sqrt().tolist()))


def _plant(fault, trainer, sharded_render, h, loss_fn):
    """A planted fault's undo, for the harness's own tests."""
    if fault == "half_batch":
        trainer.photometric_loss = lambda p, t, wt: loss_fn(p[: h // 2], t[: h // 2], wt)
        return lambda: setattr(trainer, "photometric_loss", loss_fn)
    if fault == "no_reduce":
        # each rank keeps its own band's gradient of the records, not the sum
        backward = sharded_render._Gather.backward

        def own_rows(ctx, grad):
            if ctx.replicated:
                return backward(ctx, grad)
            rows = grad.shape[0] // dist.get_world_size(ctx.group)
            me = dist.get_rank(ctx.group)
            return grad[me * rows:(me + 1) * rows].contiguous(), None, None

        sharded_render._Gather.backward = staticmethod(own_rows)
        return lambda: setattr(sharded_render._Gather, "backward", staticmethod(backward))
    return lambda: None


def rank_run(rank: int, job: dict, ctx: common.Context):
    from gaussian_splat_tpu_torch.config import TrainConfig
    from gaussian_splat_tpu_torch.ops.render import calibrate_render_config
    from gaussian_splat_tpu_torch.parallel import sharded_render
    from gaussian_splat_tpu_torch.parallel.mesh import shard_model
    from gaussian_splat_tpu_torch.train import trainer
    from gaussian_splat_tpu_torch.train.dataset import ViewDataset

    cfg, tr, seed = job["cfg"], job["traffic"], job["seed"]
    lead = rank == 0
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    tc = TrainConfig(**{k: v for k, v in tr["train"].items() if k in fields})
    if lead:
        ctx.mark("import")
    mesh, host, dev = _join(rank, job)
    ctx.device = dev
    if lead:
        ctx.mark("build and join")
    group = mesh.get_group()
    n, w, h, d = cfg["N"], cfg["width"], cfg["height"], job["ranks"]
    per = n // d
    rows = (rank * per, (rank + 1) * per)
    block = shard_model(lambda a, b: scene.make_splats(cfg, seed, dev, rows=(a, b)), mesh,
                        num_gaussians=n)
    cams = scene.cameras(cfg, tr["cameras"])
    pcams = [common.program_camera(c, dev) for c in cams]
    targets = scene.make_targets(cfg, seed, dev, len(cams))
    dataset = ViewDataset(viewmats=torch.stack([c.viewmat for c in pcams]), images=targets,
                          fx=pcams[0].fx, fy=pcams[0].fy, cx=pcams[0].cx, cy=pcams[0].cy,
                          width=w, height=h)
    if lead:
        ctx.mark("splats and targets")
    rc = calibrate_render_config(block, pcams, common.render_config(cfg, tr),
                                 **common.calibration(cfg, tr), mesh=mesh)
    if lead:
        ctx.mark("calibrate")
    state = trainer.TrainState(model=block, optimizer=trainer.make_optimizer(block, tc),
                               step=tr["train"]["start_step"])
    views = [int(v) for v in scene.view_sequence(seed, len(cams), tr["max_steps"])]
    checked = tr["checked_steps"]

    counters = sharded_render.counters
    counters.reset(d)
    if job["fault"] == "stats_lost":  # the program counts where the runner does not read
        sharded_render.counters = sharded_render.ShardCounters()
    loss_fn = trainer.photometric_loss
    undo = _plant(job["fault"], trainer, sharded_render, h, loss_fn)
    try:
        step = trainer.make_multiview_train_step(dataset, rc, tc, mesh=mesh)
        if job["fault"] == "state_unchanged":
            def step(state, view):
                with torch.no_grad():
                    img = sharded_render.render_sharded(
                        state.model, dataset.camera(view), rc, mesh).image
                return state, loss_fn(img, dataset.target(view), tc.ssim_weight)

        # warm-up: one forward and backward through the kernels, no update
        img = sharded_render.render_sharded(state.model, dataset.camera(views[0]), rc,
                                            mesh).image
        loss_fn(img, dataset.target(views[0]), tc.ssim_weight).backward()
        state.optimizer.zero_grad(set_to_none=True)
        del img
        if lead:
            ctx.mark("warm-up")

        got = {"losses": []}
        for k in range(checked):
            state, loss = step(state, views[k])
            got["losses"].append(float(loss))
            if k == 0:
                got["grad_norms"] = first_grad_norms(state.optimizer, host)
        readings = {"exchange_bytes_per_step": exchange_costs.step_bytes(n, d, w, h)}
        if lead:
            ctx.mark("checked steps")
        got["change_norms"] = change_norms(
            dict(state.model.named_parameters()),
            scene.make_splats(cfg, seed, dev, rows=rows), host)
        common.free(dev)
        dist.barrier(group=host)  # every rank ready
        if lead:
            ctx.mark("ranks ready")
        setup_s = common.now() - ctx.t0

        setup_peak = common.peak_bytes(dev)
        common.peak_reset(dev)
        before = common.launches()
        renders_before, kept_before = counters.renders, _kept(counters)
        stop = torch.zeros(1, dtype=torch.int32)
        k = checked
        start = common.now()
        while True:
            step(state, views[k])
            k += 1
            if lead:
                stop[0] = int(common.now() - start >= ctx.seconds)
            dist.broadcast(stop, src=0, group=host)
            if stop[0]:
                break
        ctx.sync()
        dist.barrier(group=host)
        window_s = common.now() - start
        steps = k - checked
        window_peak = common.peak_bytes(dev)
        launch_gap = common.launch_gap(before, KERNELS, steps, dev)
        window_renders = counters.renders - renders_before
        if window_renders:
            readings["max_records_share"] = (
                (_kept(counters) - kept_before) / window_renders / per)

        busy_s = trace_window = breakdown = None
        if job["trace"]:
            with devtrace.traced(lead) as prof:
                a = common.now()
                for j in range(tr["trace_steps"]):
                    step(state, views[k + j])
                ctx.sync()
                trace_window = common.now() - a
            dist.barrier(group=host)
            if prof is not None:
                busy_s = devtrace.device_busy(prof)[0] / 1e3
                spans = [devtrace.range_device_ms(prof, s) for s in SPANS]
                if all(calls for _, calls in spans[:2]):  # the exchange and its transpose
                    readings["exchange_ms"] = sum(ms for ms, _ in spans) / tr["trace_steps"]
                readings["busy_s"], readings["trace_window_s"] = busy_s, trace_window
                breakdown = devtrace.breakdown(prof, top=BREAKDOWN_LINES)
                del prof
        renders = 1 + checked + steps + (tr["trace_steps"] if job["trace"] else 0)
        sentinels = _band_sentinels(counters, renders)
        memory_peak = max(setup_peak, common.peak_bytes(dev))
    finally:
        undo()
        sharded_render.counters = counters
    del state, step, dataset, block
    common.free(dev)

    from splatbench.reference import train_sharded as ref

    start_rows = scene.make_splats(cfg, seed, dev, rows=rows)
    want = ref.train(start_rows, cams, targets, views[:checked],
                     scene.render_settings(cfg, tr), tr["train"], group)
    want["change_norms"] = change_norms(want.pop("params"), start_rows, host)
    del start_rows, targets
    common.free(dev)

    mine = {"peak": memory_peak, "window_peak": window_peak, "launch_gap": launch_gap}
    every = [None] * d if lead else None
    dist.gather_object(mine, every, dst=0, group=host)
    dist.barrier(group=host)
    dist.destroy_process_group()
    if not lead:
        return None

    numbers = train.compare(got, want)
    lim = ctx.limits
    checks = {name: common.check(numbers[name], lim[name]) for name in numbers}
    checks["sentinels"] = common.check(sum(sentinels[s] for s in common.SENTINELS), 0)
    checks["stats_missing"] = common.check(sentinels["missing"], 0)
    checks["launches_off"] = common.check(max(r["launch_gap"] for r in every), 0)
    return common.Outcome(
        e2e={"setup_s": setup_s, "step_ms": 1e3 * window_s / steps,
             "peak_mem_gib": max(r["window_peak"] for r in every) / 2 ** 30},
        readings=readings, checks=checks, attempted=steps, failed=0,
        memory_peak_bytes=max(r["peak"] for r in every), busy_s=busy_s,
        window_s=trace_window, breakdown=breakdown, setup_parts=ctx.marks,
    )


def _kept(counters) -> int:
    """The largest band's kept records, summed over the counted renders."""
    return 0 if counters.max_kept is None else int(counters.max_kept)


def _band_sentinels(counters, renders: int) -> dict:
    """Every band's sentinels summed over the renders the counters saw, and
    how far those renders are from the `renders` the runner made."""
    out = dict.fromkeys(common.SENTINELS, 0)
    out["missing"] = abs(renders - counters.renders)
    stats = counters.band_stats()
    if stats is not None:
        out.update({s: int(getattr(stats, s).sum()) for s in common.SENTINELS})
    return out


def run(ctx: common.Context) -> common.Outcome:
    lacking = missing_hooks()
    if lacking:
        raise RuntimeError(f"the program lacks what this runner reads: {', '.join(lacking)}")
    return launch(rank_run, job_of(ctx), ctx)
