"""Runner `train`: training at a fixed splat count, a closed loop of steps.

Stands for 3DGS's steps 15k-30k, where densification has stopped. Set-up
builds one training state (the program's `GaussianModel`, its per-group
Adam) and one step function, `trainer.make_multiview_train_step(dataset,
config, TrainConfig(...))`, and drives that same state through the first
`checked_steps` steps of the run's view sequence (uniform draws over the
configuration's views, from the seed); the window then calls the same step
function on the following views with no synchronisation of its own, and
synchronises once at the end. `step_ms` is the window's length over the
steps completed in it.

Correct: the reference (splatbench/reference/train.py, float64) follows the
same first steps from the same splats, views and targets. Compared: each
step's loss, the first gradient's norm per leaf (the program's read from
its Adam state after one step), and the norm per leaf of the change the
first steps made, as it stood before the window; beside them the binning
sentinels over every step (all 0; `stats_missing` 0 says that every render
the run made reached the recorder) and one launch of each kernel a step.
"""

from __future__ import annotations

import dataclasses
import statistics

import torch

from splatbench import costs, devtrace, scene
from splatbench.runners import common

KERNELS = ("raster_fwd", "raster_bwd", "rank_perm", "segsum")


class _Recorder:
    """Keeps the binning counters of every frame the trainer renders: the
    trainer's `render` wrapped for the run (a call and an append a step)."""

    def __init__(self, trainer):
        self.trainer, self.inner, self.stats = trainer, trainer.render, []

        def render(*args, **kwargs):
            out = self.inner(*args, **kwargs)
            self.stats.append(out.stats)
            return out

        trainer.render = render

    def close(self):
        self.trainer.render = self.inner


def first_grad_norms(optimizer) -> dict:
    """Each leaf's first gradient, from Adam's first moment after one step:
    m = (1 − β1)·g."""
    out = {}
    for group in optimizer.param_groups:
        (p,) = group["params"]
        m = optimizer.state.get(p, {}).get("exp_avg")
        g = (torch.zeros((), dtype=torch.float64) if m is None
             else m.double() / (1.0 - group["betas"][0]))
        out[group["name"]] = float(torch.linalg.vector_norm(g))
    return out


def change_norms(params: dict, start: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(params[k].detach().double() - start[k].double()))
            for k in scene.LEAVES}


def compare(got: dict, want: dict) -> dict:
    """The gaps between the program's readings and the reference's, each
    leaf measured against the larger of its own reference norm and the
    median leaf's; the change leaves out leaves that the reference's first
    gradient leaves at rounding (under a thousandth of the median leaf's)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))

    def worst(name, leaves):
        ref = {k: want[name][k] for k in leaves}
        scale = statistics.median(ref.values())
        return max(abs(got[name][k] - ref[k]) / max(ref[k], scale, 1e-300) for k in leaves)

    g = want["grad_norms"]
    moving = [k for k in scene.LEAVES if g[k] >= 1e-3 * statistics.median(g.values())]
    return {"loss_gap": loss_gap, "grad_gap": worst("grad_norms", list(scene.LEAVES)),
            "change_gap": worst("change_norms", moving)}


def reference_run(cfg, tr, seed, device, cams, targets, views, dtype, param_dtype, counts):
    """The reference's (or, with lower dtypes, the control's) readings."""
    from splatbench.reference import train as ref_train

    start = scene.make_splats(cfg, seed, device)
    out = ref_train.train(start, cams, targets, views, scene.render_settings(cfg, tr),
                          tr["train"], dtype, param_dtype, counts)
    out["change_norms"] = change_norms(out.pop("params"), start)
    return out


def run(ctx: common.Context) -> common.Outcome:
    from gaussian_splat_tpu_torch.config import TrainConfig
    from gaussian_splat_tpu_torch.models.gaussians import GaussianModel
    from gaussian_splat_tpu_torch.ops.render import calibrate_render_config
    from gaussian_splat_tpu_torch.train import trainer
    from gaussian_splat_tpu_torch.train.dataset import ViewDataset

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    tc = TrainConfig(**{k: v for k, v in tr["train"].items() if k in fields})
    ctx.mark("import")
    common.build_kernels(dev)
    ctx.mark("build")
    n, w, h = cfg["N"], cfg["width"], cfg["height"]
    model = GaussianModel(*(scene.make_splats(cfg, ctx.seed, dev)[k] for k in scene.LEAVES))
    cams = scene.cameras(cfg, tr["cameras"])
    pcams = [common.program_camera(c, dev) for c in cams]
    targets = scene.make_targets(cfg, ctx.seed, dev, len(cams))
    dataset = ViewDataset(viewmats=torch.stack([c.viewmat for c in pcams]), images=targets,
                          fx=pcams[0].fx, fy=pcams[0].fy, cx=pcams[0].cx, cy=pcams[0].cy,
                          width=w, height=h)
    ctx.mark("splats and targets")
    rc = calibrate_render_config(model, pcams, common.render_config(cfg, tr),
                                 **common.calibration(cfg, tr))
    ctx.mark("calibrate")
    state = trainer.TrainState(model=model, optimizer=trainer.make_optimizer(model, tc),
                               step=tr["train"]["start_step"])
    views = [int(v) for v in scene.view_sequence(ctx.seed, len(cams), tr["max_steps"])]
    checked = tr["checked_steps"]

    recorder = _Recorder(trainer)
    if ctx.fault == "stats_lost":  # the program renders past the recorder
        recorder.close()
    loss_fn = trainer.photometric_loss
    try:
        if ctx.fault == "half_batch":
            trainer.photometric_loss = lambda p, t, wt: loss_fn(p[: h // 2], t[: h // 2], wt)
        step = trainer.make_multiview_train_step(dataset, rc, tc)
        if ctx.fault == "state_unchanged":
            def step(state, view):
                with torch.no_grad():
                    img = trainer.render(state.model, dataset.camera(view), rc).image
                return state, loss_fn(img, dataset.target(view), tc.ssim_weight)

        # warm-up: one forward and backward through the kernels, no update
        img = trainer.render(state.model, dataset.camera(views[0]), rc).image
        loss_fn(img, dataset.target(views[0]), tc.ssim_weight).backward()
        state.optimizer.zero_grad(set_to_none=True)
        del img
        ctx.mark("warm-up")

        got = {"losses": []}
        with devtrace.traced(ctx.trace) as prof:
            for k in range(checked):
                state, loss = step(state, views[k])
                got["losses"].append(float(loss))
                if k == 0:
                    got["grad_norms"] = first_grad_norms(state.optimizer)
            ctx.sync()
        readings = {"n": n}
        if prof is not None:
            readings["kernel_ms"] = {k: devtrace.kernel_ms(prof, k) for k in KERNELS}
            del prof
        ctx.mark("checked steps")
        got["change_norms"] = change_norms(dict(state.model.named_parameters()),
                                           scene.make_splats(cfg, ctx.seed, dev))
        common.free(dev)
        ctx.mark("change read")
        setup_s = common.now() - ctx.t0

        setup_peak = common.peak_bytes(dev)
        common.peak_reset(dev)
        before = common.launches()
        k = checked
        start = common.now()
        while True:
            step(state, views[k])
            k += 1
            if common.now() - start >= ctx.seconds:
                break
        ctx.sync()
        window_s = common.now() - start
        steps = k - checked
        window_peak = common.peak_bytes(dev)
        launch_gap = common.launch_gap(before, KERNELS, steps, dev)

        busy_s = trace_window = breakdown = None
        if ctx.trace:
            with devtrace.traced(True) as prof:
                a = common.now()
                for j in range(tr["trace_steps"]):
                    step(state, views[k + j])
                ctx.sync()
                trace_window = common.now() - a
            busy_s = devtrace.device_busy(prof)[0] / 1e3
            adam_ms, adam_calls = devtrace.range_device_ms(prof, "Optimizer.step#Adam.step")
            readings["adam_ms"] = adam_ms / adam_calls if adam_calls else None
            readings["busy_s"], readings["trace_window_s"] = busy_s, trace_window
            breakdown = devtrace.breakdown(prof)
            del prof
        # every render the run made: the warm-up, the checked steps, the
        # window's and the traced steps, one a step
        renders = 1 + checked + steps + (tr["trace_steps"] if ctx.trace else 0)
        sentinels = common.tally(recorder.stats, renders)
        memory_peak = max(setup_peak, common.peak_bytes(dev))
    finally:
        recorder.close()
        trainer.photometric_loss = loss_fn
    del state, step, dataset, model, recorder
    common.free(dev)

    readings.update(steps=steps, step_ms=1e3 * window_s / steps,
                    pairs_per_splat=sentinels["num_pairs_mean"] / n)
    want = reference_run(cfg, tr, ctx.seed, dev, cams, targets, views[:checked],
                         torch.float64, torch.float64, ctx.trace)
    numbers = compare(got, want)
    if ctx.trace:
        per_step = [costs.kernel_costs(c, n, w, h) for c in want["counts"]]
        readings["bound_ms"] = {k: sum(p[k].attainable_ms() for p in per_step) for k in KERNELS}
        readings["flops_per_step"] = sum(
            costs.step_flops(c, n, cfg["sh_degree"], w, h) for c in want["counts"]) / checked
    lim = ctx.limits
    checks = {name: common.check(numbers[name], lim[name]) for name in numbers}
    checks["sentinels"] = common.check(sum(sentinels[s] for s in common.SENTINELS), 0)
    checks["stats_missing"] = common.check(sentinels["missing"], 0)
    checks["launches_off"] = common.check(launch_gap, 0)
    return common.Outcome(
        e2e={"setup_s": setup_s, "step_ms": 1e3 * window_s / steps,
             "peak_mem_gib": window_peak / 2 ** 30},
        readings=readings, checks=checks, attempted=steps, failed=0,
        memory_peak_bytes=memory_peak, busy_s=busy_s, window_s=trace_window,
        breakdown=breakdown, setup_parts=ctx.marks,
    )
