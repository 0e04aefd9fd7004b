"""The sharded train step against the benchmark's references, on 4 gloo ranks
on the CPU: splatbench/reference/train_sharded.py (the model split over the
ranks) equals splatbench/reference/train.py in one process; the port's
`make_multiview_train_step(mesh=)` stays within the `rubble40m.train4`
cell's own limits of it; the sharded path's counters equal hand counts; the
calibration over the ranks' blocks (`calibrate_render_config(mesh=)`) equals
the whole model's with `mesh_ndev=4`; and `shard_model` from a row maker
equals slicing the whole model.

One spawn of 4 ranks (each pinned to one thread, joined under a timeout)
runs every case; the tests read rank 0's results. The scene: the cell's
configuration cut to 2,000 splats at 64×48 with 4 views, its splats made
larger so that they cover pixels at that size."""

import dataclasses
import json
import socket
import time
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
RANKS = 4
JOIN_TIMEOUT = 180  # seconds for every rank to finish
SEED = 2**31 + 4242
N, WIDTH, HEIGHT, VIEWS = 2000, 64, 48, 4
LEAVES = ("means", "quats", "log_scales", "opacity_logits", "sh")


def _config():
    cfg = json.loads((ROOT / "splatbench/configs/rubble40m.json").read_text())
    cfg.update(N=N, width=WIDTH, height=HEIGHT)
    cfg["cameras"] = {k: {**v, "count": VIEWS} for k, v in cfg["cameras"].items()}
    for reg in cfg["scene"]["regions"]:
        reg["log_scale"] = {"mean": -3.5, "std": 0.5, "min": -5.0, "max": -2.5}
    return cfg


def _traffic():
    return json.loads((ROOT / "splatbench/traffic/train4.json").read_text())


def _limits():
    return json.loads((ROOT / "splatbench/limits/rubble40m.train4.json").read_text())


def _inputs(device="cpu"):
    """(cfg, traffic, cameras, targets, views) of the test scene."""
    from splatbench import scene

    cfg, tr = _config(), _traffic()
    cams = scene.cameras(cfg, tr["cameras"])
    targets = scene.make_targets(cfg, SEED, device, len(cams))
    views = [int(v) for v in scene.view_sequence(SEED, len(cams), tr["checked_steps"])]
    return cfg, tr, cams, targets, views


def _program_inputs(cfg, tr, cams, targets):
    from gaussian_splat_tpu_torch.train.dataset import ViewDataset
    from splatbench.runners import common

    pcams = [common.program_camera(c, "cpu") for c in cams]
    dataset = ViewDataset(viewmats=torch.stack([c.viewmat for c in pcams]), images=targets,
                          fx=pcams[0].fx, fy=pcams[0].fy, cx=pcams[0].cx, cy=pcams[0].cy,
                          width=WIDTH, height=HEIGHT)
    return pcams, dataset


# -- the ranks ------------------------------------------------------------------


def _gathered(t, group):
    out = t.new_empty((dist.get_world_size(group) * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def _rank_main(rank, port, out_path):
    torch.set_num_threads(1)
    from gaussian_splat_tpu_torch.config import TrainConfig
    from gaussian_splat_tpu_torch.models.gaussians import GaussianModel
    from gaussian_splat_tpu_torch.ops.render import calibrate_render_config
    from gaussian_splat_tpu_torch.parallel import sharded_render
    from gaussian_splat_tpu_torch.parallel.mesh import make_mesh, shard_model
    from gaussian_splat_tpu_torch.train import trainer
    from splatbench import scene
    from splatbench.reference import train_sharded as ref_sharded
    from splatbench.runners import common, train_sharded

    mesh = make_mesh(RANKS, device="cpu", rank=rank, init_method=f"tcp://127.0.0.1:{port}")
    group = mesh.get_group()
    host = dist.new_group(backend="gloo")
    cfg, tr, cams, targets, views = _inputs()
    pcams, dataset = _program_inputs(cfg, tr, cams, targets)
    per = N // RANKS
    rows = (rank * per, (rank + 1) * per)
    out = {}

    block = shard_model(lambda a, b: scene.make_splats(cfg, SEED, "cpu", rows=(a, b)), mesh,
                        num_gaussians=N)
    whole = scene.make_splats(cfg, SEED, "cpu")
    sliced = shard_model(GaussianModel.create(*(whole[k] for k in LEAVES), device="cpu"), mesh)
    out["rows_equal"] = all(torch.equal(getattr(block, k), getattr(sliced, k)) for k in LEAVES)
    rc = calibrate_render_config(block, pcams, common.render_config(cfg, tr),
                                 **common.calibration(cfg, tr), mesh=mesh)
    out["calibrated"] = dataclasses.asdict(rc)

    # the reference over the ranks, from this rank's rows
    start = scene.make_splats(cfg, SEED, "cpu", rows=rows)
    want = ref_sharded.train(start, cams, targets, views, scene.render_settings(cfg, tr),
                             tr["train"], group)
    out["ref"] = {"losses": want["losses"], "grad_norms": want["grad_norms"],
                  "params": {k: _gathered(v, group) for k, v in want["params"].items()},
                  "change_norms": train_sharded.change_norms(want["params"], start, host)}

    # the port's steps
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    tc = TrainConfig(**{k: v for k, v in tr["train"].items() if k in fields})
    state = trainer.TrainState(model=block, optimizer=trainer.make_optimizer(block, tc),
                               step=tr["train"]["start_step"])
    step = trainer.make_multiview_train_step(dataset, rc, tc, mesh=mesh)
    counters = sharded_render.counters
    counters.reset()
    got = {"losses": []}
    for k, view in enumerate(views):
        state, loss = step(state, view)
        got["losses"].append(float(loss))
        if k == 0:
            got["grad_norms"] = train_sharded.first_grad_norms(state.optimizer, host)
    got["change_norms"] = train_sharded.change_norms(
        dict(state.model.named_parameters()), start, host)
    out["port"] = got
    out["steps_counted"] = {"renders": counters.renders, "bands": counters.bands.clone(),
                            "exchange_bwd_bytes": counters.exchange_bwd_bytes}

    # one render's counters against its own stats
    counters.reset()
    with torch.no_grad():
        frame = sharded_render.render_sharded(state.model, dataset.camera(views[0]), rc, mesh)
    out["render"] = {"renders": counters.renders, "exchange_bytes": counters.exchange_bytes,
                     "bands": counters.bands.clone(), "max_kept": int(counters.max_kept),
                     "stats": {k: v.clone() for k, v in frame.stats._asdict().items()},
                     "model": {k: _gathered(getattr(state.model, k).detach(), group)
                               for k in LEAVES},
                     "config": dataclasses.asdict(rc)}
    if rank == 0:
        torch.save(out, out_path)
    dist.barrier(group=host)
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Rank 0's results from one spawn of 4 ranks."""
    out_path = str(tmp_path_factory.mktemp("sharded_ref") / "rank0.pt")
    ctx = mp.start_processes(_rank_main, args=(_free_port(), out_path), nprocs=RANKS,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT
    try:
        while not ctx.join(timeout=2):  # raises as soon as a rank fails
            assert time.monotonic() < deadline, f"the ranks did not finish in {JOIN_TIMEOUT} s"
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(timeout=10)
    return torch.load(out_path, weights_only=False)


@pytest.fixture(scope="module")
def one_process():
    """splatbench/reference/train.py on the whole test scene, in this process."""
    from splatbench import scene
    from splatbench.reference import train as ref_train

    cfg, tr, cams, targets, views = _inputs()
    start = scene.make_splats(cfg, SEED, "cpu")
    out = ref_train.train(start, cams, targets, views, scene.render_settings(cfg, tr),
                          tr["train"])
    out["change_norms"] = {k: float(torch.linalg.vector_norm(
        out["params"][k] - start[k].double())) for k in LEAVES}
    return out


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


# -- the tests --------------------------------------------------------------------


def test_reference_over_ranks_equals_one_process_losses(ranks, one_process):
    got, want = ranks["ref"]["losses"], one_process["losses"]
    assert len(got) == len(want) == 3
    assert all(_rel(a, b) < 1e-10 for a, b in zip(got, want)), (got, want)


def test_reference_over_ranks_equals_one_process_first_gradients(ranks, one_process):
    got, want = ranks["ref"]["grad_norms"], one_process["grad_norms"]
    assert all(want[k] > 0 for k in LEAVES)
    assert all(_rel(got[k], want[k]) < 1e-10 for k in LEAVES), (got, want)


@pytest.mark.parametrize("leaf", LEAVES)
def test_reference_over_ranks_equals_one_process_change(ranks, one_process, leaf):
    got, want = ranks["ref"]["change_norms"][leaf], one_process["change_norms"][leaf]
    assert _rel(got, want) < 1e-10, (got, want)
    params = ranks["ref"]["params"][leaf]
    scale = float(one_process["params"][leaf].abs().max())
    assert torch.allclose(params, one_process["params"][leaf], rtol=0, atol=1e-10 * scale)


def test_port_over_ranks_within_the_cells_limits(ranks):
    from splatbench.runners import train

    numbers = train.compare(ranks["port"], ranks["ref"])
    limits = _limits()
    assert all(numbers[k] <= limits[k] for k in limits), (numbers, limits)


def test_exchange_bytes_equal_hand_count(ranks):
    r = ranks["render"]
    assert r["renders"] == 1
    assert r["exchange_bytes"] == (RANKS - 1) * N // RANKS * 52
    # the steps' transposes: the same bytes a render
    s = ranks["steps_counted"]
    assert s["renders"] == 3 and s["exchange_bwd_bytes"] == 3 * (RANKS - 1) * N // RANKS * 52


def test_band_records_equal_plain_count(ranks):
    """Records each band took in (all N) and kept: a plain count of the valid
    records whose rect, its y-extent rounded up to 1/256 px, meets the
    band's pixel rows."""
    from gaussian_splat_tpu_torch.config import RenderConfig
    from gaussian_splat_tpu_torch.models.gaussians import GaussianModel
    from gaussian_splat_tpu_torch.ops.render import _project_and_shade
    from gaussian_splat_tpu_torch.parallel.sharded_render import COL_BAND_IN, COL_BAND_KEPT
    from splatbench.runners import common

    r = ranks["render"]
    cfg, tr, cams, _, views = _inputs()
    model = GaussianModel.create(*(r["model"][k] for k in LEAVES), device="cpu")
    rc = RenderConfig(**r["config"])
    proj, _ = _project_and_shade(model, common.program_camera(cams[views[0]], "cpu"), rc)
    my, ry = proj.means2d[:, 1], torch.ceil(proj.extents[:, 1] * 256.0) / 256.0
    band_h = -(-(-(-HEIGHT // 16)) // RANKS) * 16
    want = [int((proj.valid & (my + ry > b * band_h) & (my - ry < (b + 1) * band_h)).sum())
            for b in range(RANKS)]
    assert r["bands"][:, COL_BAND_KEPT].tolist() == want
    assert r["bands"][:, COL_BAND_IN].tolist() == [N] * RANKS
    assert r["max_kept"] == max(want)


def test_band_stats_equal_the_renders_own(ranks):
    r = ranks["render"]
    for i, (name, v) in enumerate(r["stats"].items()):
        assert r["bands"][:, i].tolist() == v.tolist(), name
    assert ranks["steps_counted"]["bands"][:, 1:5].sum() == 0  # every sentinel, every band


def test_blockwise_calibration_equals_whole_model(ranks):
    from gaussian_splat_tpu_torch.models.gaussians import GaussianModel
    from gaussian_splat_tpu_torch.ops.render import calibrate_render_config
    from splatbench import scene
    from splatbench.runners import common

    cfg, tr, cams, _, _ = _inputs()
    leaves = scene.make_splats(cfg, SEED, "cpu")
    whole = calibrate_render_config(
        GaussianModel.create(*(leaves[k] for k in LEAVES), device="cpu"),
        [common.program_camera(c, "cpu") for c in cams], common.render_config(cfg, tr),
        **common.calibration(cfg, tr), mesh_ndev=RANKS)
    assert ranks["calibrated"] == dataclasses.asdict(whole)
    assert whole.shard_capacity_margin > 0


def test_shard_model_from_rows_equals_slicing(ranks):
    assert ranks["rows_equal"]
