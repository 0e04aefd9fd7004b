"""The port's sharded path across processes: `make_mesh` → `shard_model` →
`render_sharded`, `sharded_binning_stats` and `fit(mesh=)`, on gloo ranks on
the CPU, against the JAX single-chip `render` (jnp_tile) and `jax.grad`, and
against the port's own single-process render; and, in the test process,
`make_mesh`'s refusals, `pad_to_multiple` and `local_batch_slice`.

One spawn of 4 ranks (each pinned to one thread, joined under a timeout)
runs every case once: the 4-rank cases, then, on ranks 0 and 1 in a new
process group, the 2-rank cases; the tests read rank 0's results.
The cases mirror tests/test_sharded.py:38-249 (which holds the JAX
`render_sharded` to the single chip); this file never calls the JAX
`render_sharded` itself. Tolerances: images atol 3e-5 / rtol 1e-4 against
JAX, and bit for bit against the port's single process (the records that
projection computes on a block are its rows on all N, and a band composites
each tile's pairs in the single-process order); gradients atol 5e-6 /
rtol 3e-3.

This module imports no JAX at its top: the ranks import it to find their
function. The JAX references are computed in the test process only."""

import functools
import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gaussian_splat_tpu_torch import convert

IMAGE_ATOL, IMAGE_RTOL = 3e-5, 1e-4
GRAD_ATOL, GRAD_RTOL = 5e-6, 3e-3
JOIN_TIMEOUT = 180  # seconds for every rank of a world to finish
LEAVES = ("means", "quats", "log_scales", "opacity_logits", "sh")


def _leaves(n, seed=0, sh_degree=1, scale_range=(0.02, 0.1)):
    """The scene of tests/test_sharded.py's _setup, made with numpy."""
    return convert.random_leaves(seed, n, sh_degree=sh_degree, extent=1.2,
                                 scale_range=scale_range)


def _crowded_leaves():
    """Every splat crowded into the top band (test_sharded_imbalanced_scene_
    reports_drops): world y up, image y down."""
    leaves = _leaves(512, seed=3, sh_degree=0, scale_range=(0.02, 0.08))
    leaves["means"] = (leaves["means"] * np.float32([0.3, 0.05, 0.3])
                       + np.float32([0.0, 1.45, 0.0])).astype(np.float32)
    return leaves


def _camera(width, height):
    """(viewmat, fx, fy, cx, cy, width, height) of the tests' camera, from the
    JAX package's own constructor (both packages get the same numbers)."""
    from gaussian_splat_tpu.camera import Camera as JaxCamera

    c = JaxCamera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, width, height)
    return tuple(np.asarray(v) for v in (c.viewmat, c.fx, c.fy, c.cx, c.cy)) + (width, height)


def _target(width, height, seed=9):
    return np.random.default_rng(seed).uniform(0, 1, (height, width, 3)).astype(np.float32)


def _cases(world):
    """{name: case} for one world size. 80 px are 5 tile rows: padded to 6
    over 2 ranks and to 8 over 4, then cropped back."""
    cases = {
        "match": dict(kind="render", leaves=_leaves(256), camera=_camera(128, 80), cfg={}),
        "a2a_match": dict(kind="render", leaves=_leaves(256), camera=_camera(128, 80),
                          cfg=dict(shard_exchange="all_to_all")),
        "grads": dict(kind="grads", leaves=_leaves(128), camera=_camera(64, 64),
                      target=_target(64, 64), cfg={}),
    }
    if world == 4:
        cases.update({
            "train": dict(kind="train", leaves=_leaves(256), camera=_camera(64, 64), steps=2,
                          target=np.zeros((64, 64, 3), np.float32), cfg={}),
            "grads_a2a": dict(kind="grads", leaves=_leaves(128), camera=_camera(64, 64),
                              target=_target(64, 64), cfg=dict(shard_exchange="all_to_all")),
            "stats": dict(kind="render", leaves=_leaves(512), camera=_camera(128, 128), cfg={},
                          binning_stats=True),
            "crowded_tight": dict(kind="render", leaves=_crowded_leaves(),
                                  camera=_camera(128, 128),
                                  cfg=dict(shard_capacity_margin=0.0, shard_capacity_floor=0)),
            "crowded_roomy": dict(kind="render", leaves=_crowded_leaves(),
                                  camera=_camera(128, 128), cfg=dict(shard_capacity_margin=1.0)),
            "a2a_overflow": dict(kind="render", leaves=_leaves(512), camera=_camera(128, 128),
                                 cfg=dict(shard_exchange="all_to_all", a2a_capacity_factor=0.25,
                                          shard_capacity_floor=0)),
        })
    return cases


# -- the ranks ------------------------------------------------------------------


def _gathered(t, group):
    out = t.new_empty((dist.get_world_size(group) * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def _leaf_moments(state):
    """{leaf: (exp_avg, exp_avg_sq)} of a train state's Adam, as numpy."""
    return {k: tuple(state.optimizer.state[getattr(state.model, k)][m].numpy().copy()
                     for m in ("exp_avg", "exp_avg_sq")) for k in LEAVES}


def _run_case(case, mesh, lead, workdir):
    """One case on every rank; rank 0's result (numpy)."""
    from gaussian_splat_tpu_torch.config import RenderConfig, TrainConfig
    from gaussian_splat_tpu_torch.ops.render import render
    from gaussian_splat_tpu_torch.parallel.mesh import shard_model
    from gaussian_splat_tpu_torch.parallel.sharded_render import (
        render_sharded, sharded_binning_stats,
    )
    from gaussian_splat_tpu_torch.train.checkpoint import latest_step, restore_checkpoint
    from gaussian_splat_tpu_torch.train.trainer import (
        create_train_state, fit, make_train_step,
    )

    group = mesh.get_group("dev")
    model = convert.model_from_numpy(case["leaves"], "cpu")
    camera = convert.camera_from_numpy(*case["camera"], device="cpu")
    cfg = RenderConfig(**case["cfg"])
    block = shard_model(model, mesh)
    result = {}
    if case["kind"] == "render":
        with torch.no_grad():
            out = render_sharded(block, camera, cfg, mesh)
            again = render_sharded(block, camera, cfg, mesh)
            if case.get("binning_stats"):
                result["binning_stats"] = {
                    k: v.numpy() for k, v in
                    sharded_binning_stats(block, camera, cfg, mesh)._asdict().items()}
            single = render(model, camera, cfg) if lead else None
        result.update(
            image=out.image.numpy(), t_final=out.t_final.numpy(), depth=out.depth.numpy(),
            stats={k: v.numpy() for k, v in out.stats._asdict().items()},
            bitwise_repeatable=bool(torch.equal(out.image, again.image)
                                    and torch.equal(out.t_final, again.t_final)),
        )
        if lead:
            result.update(single_image=single.image.numpy(),
                          single_alpha=single.alpha.numpy(), single_depth=single.depth.numpy())
    elif case["kind"] == "grads":
        img = render_sharded(block, camera, cfg, mesh).image
        torch.mean((img - torch.from_numpy(case["target"])) ** 2).backward()
        result["grads"] = {k: _gathered(getattr(block, k).grad, group).numpy() for k in LEAVES}
    elif case["kind"] == "train":
        # checkpoints at every step; then a fresh state of this rank's block
        # resumes from the newest one for one step more
        steps, ckpt = case["steps"], os.path.join(workdir, "ckpt")
        tc = TrainConfig(num_steps=steps, checkpoint_dir=ckpt, checkpoint_every=1)
        target = torch.from_numpy(case["target"])
        fitted, history = fit(block, camera, target, cfg, tc, mesh=mesh, log_every=1)
        resumed = restore_checkpoint(ckpt, create_train_state(block, tc), mesh)
        resumed_step = resumed.step
        resumed, _ = make_train_step(camera, cfg, tc, mesh)(resumed, target)
        result.update(history=history, resumed_step=resumed_step, fitted={
            k: _gathered(getattr(fitted, k).detach(), group).numpy() for k in LEAVES})
        result["resumed"] = {k: _gathered(getattr(resumed.model, k).detach(), group).numpy()
                             for k in LEAVES}
        if lead:
            saved = torch.load(os.path.join(ckpt, f"step_{latest_step(ckpt):08d}.pt"),
                               weights_only=True)
            result["files"] = sorted(os.listdir(ckpt))
            result["saved"] = dict(step=saved["step"], model={
                k: v.numpy() for k, v in saved["model"].items()}, moments={
                k: tuple(saved["optimizer"]["state"][i][m].numpy()
                         for m in ("exp_avg", "exp_avg_sq")) for i, k in enumerate(LEAVES)})
            # the uninterrupted single process, one step longer, seen after `steps`
            seen = {}

            def snapshot(i, loss, state):
                if i == steps - 1:
                    seen["model"] = {k: getattr(state.model, k).detach().numpy().copy()
                                     for k in LEAVES}
                    seen["moments"] = _leaf_moments(state)

            longer = TrainConfig(num_steps=steps + 1)
            single, single_history = fit(model, camera, target, cfg, longer, log_every=1,
                                         callback=snapshot)
            result.update(single_history=single_history[:steps], single_fitted=seen["model"],
                          single_moments=seen["moments"],
                          single_longer={k: getattr(single, k).detach().numpy()
                                         for k in LEAVES})
    return result


def _rank_main(rank, ports, cases_by_world, out_dir):
    """Every world of `cases_by_world` in turn, largest first, each in its
    own process group of the first `world` ranks; rank 0 saves each
    world's results."""
    torch.set_num_threads(1)
    from gaussian_splat_tpu_torch.parallel.mesh import make_mesh

    for (world, cases), port in zip(cases_by_world.items(), ports):
        if rank >= world:
            return
        mesh = make_mesh(world, device="cpu", rank=rank, init_method=f"tcp://127.0.0.1:{port}")
        workdir = os.path.join(out_dir, f"world{world}")
        results = {name: _run_case(case, mesh, rank == 0, workdir)
                   for name, case in cases.items()}
        if rank == 0:
            torch.save(results, os.path.join(out_dir, f"world{world}.pt"))
        dist.barrier()
        dist.destroy_process_group()


def _free_ports(k):
    socks = [socket.socket() for _ in range(k)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world size: (world size, cases, {case: rank 0's result})}, from one
    spawn of 4 ranks."""
    cases_by_world = {4: _cases(4), 2: _cases(2)}
    out_dir = tmp_path_factory.mktemp("worlds")
    ctx = mp.start_processes(
        _rank_main, args=(_free_ports(len(cases_by_world)), cases_by_world, str(out_dir)),
        nprocs=max(cases_by_world), join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT
    try:
        while not ctx.join(timeout=2):  # raises as soon as a rank fails
            assert time.monotonic() < deadline, f"the ranks did not finish in {JOIN_TIMEOUT} s"
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(timeout=10)
    return {world: (world, cases, torch.load(out_dir / f"world{world}.pt", weights_only=False))
            for world, cases in cases_by_world.items()}


@pytest.fixture
def world2(worlds):
    return worlds[2]


@pytest.fixture
def world4(worlds):
    return worlds[4]


@pytest.fixture(params=[2, 4], ids=lambda w: f"{w}ranks")
def world(request, worlds):
    return worlds[request.param]


# -- the JAX references ---------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_render(n, width, height):
    """JAX single-chip image of the _leaves(n) scene (jnp_tile)."""
    import jax
    import jax.numpy as jnp
    from gaussian_splat_tpu.camera import Camera as JaxCamera
    from gaussian_splat_tpu.config import RenderConfig as JaxConfig
    from gaussian_splat_tpu.models.gaussians import GaussianModel as JaxModel
    from gaussian_splat_tpu.ops.render import render as jax_render

    cam = JaxCamera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, width, height)
    cfg = JaxConfig(backend="jnp_tile")
    return np.asarray(jax.jit(lambda m: jax_render(m, cam, cfg).image)(JaxModel.create(**_leaves(n))))


@functools.lru_cache(maxsize=None)
def _jax_grads(n, width, height):
    """jax.grad of the mean squared error of the _leaves(n) scene against
    _target(width, height), single chip (jnp_tile). (The photometric loss,
    whose SSIM windows cross the bands' borders, is the train case's, held
    against the single process.)"""
    import jax
    import jax.numpy as jnp
    from gaussian_splat_tpu.camera import Camera as JaxCamera
    from gaussian_splat_tpu.config import RenderConfig as JaxConfig
    from gaussian_splat_tpu.models.gaussians import GaussianModel as JaxModel
    from gaussian_splat_tpu.ops.render import render as jax_render

    cam = JaxCamera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, width, height)
    cfg = JaxConfig(backend="jnp_tile")
    target = jnp.asarray(_target(width, height))

    def loss(m):
        return jnp.mean((jax_render(m, cam, cfg).image - target) ** 2)

    g = jax.jit(jax.grad(loss))(JaxModel.create(**_leaves(n)))
    return {k: np.asarray(getattr(g, k)) for k in LEAVES}


# -- the tests --------------------------------------------------------------------


def _assert_matches_single(res, case, what, jax_too=True):
    """Within tolerance of JAX's single chip; bit for bit the port's single
    process (image, alpha, depth)."""
    assert res["image"].shape == (case["camera"][6], case["camera"][5], 3)
    if jax_too:
        want = _jax_render(case["leaves"]["means"].shape[0], *case["camera"][5:])
        np.testing.assert_allclose(res["image"], want, atol=IMAGE_ATOL, rtol=IMAGE_RTOL,
                                   err_msg=what)
    np.testing.assert_array_equal(res["image"], res["single_image"], err_msg=what)
    np.testing.assert_array_equal(1.0 - res["t_final"], res["single_alpha"], err_msg=what)
    np.testing.assert_array_equal(res["depth"], res["single_depth"], err_msg=what)


@pytest.mark.parametrize("name", ["match", "a2a_match"])
def test_sharded_matches_single_chip(world, name):
    size, cases, results = world
    res = results[name]
    _assert_matches_single(res, cases[name], f"{name}, {size} ranks")
    assert int(res["stats"]["dropped_gaussians"].sum()) == 0
    assert res["bitwise_repeatable"]


def test_sharded_nondivisible_tile_rows(world):
    """5 tile rows do not divide over 2 or 4 ranks: the frame is padded to
    equal bands, rendered, and cropped to 80 rows; the padding band(s) hold
    no pair. (test_sharded_matches_single_chip holds the frame itself.)"""
    size, cases, results = world
    res = results["match"]
    rows = -(-5 // size)
    assert rows * size > 5 and res["image"].shape == (80, 128, 3)
    assert res["stats"]["num_pairs"].shape == (size,)
    if size == 4:  # tile rows 6 and 7 are padding
        assert int(res["stats"]["num_pairs"][3]) == 0


@pytest.mark.parametrize("size,name", [(2, "grads"), (4, "grads"), (4, "grads_a2a")])
def test_sharded_gradients_match_jax_grad(request, size, name):
    """Gathered from every rank's block against jax.grad of the single chip:
    neither D times too large (a summing transpose of the frame's gather) nor
    short of a band (a missing reduce-scatter)."""
    _, cases, results = request.getfixturevalue(f"world{size}")
    case = cases[name]
    want = _jax_grads(case["leaves"]["means"].shape[0], *case["camera"][5:])
    for k in LEAVES:
        got = results[name]["grads"][k]
        assert np.isfinite(got).all(), k
        np.testing.assert_allclose(got, want[k], atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=f"{name}, {size} ranks: d{k}")
        assert float(np.abs(want[k]).max()) > 10 * GRAD_ATOL, k


def test_sharded_train_step(world4):
    """fit(mesh=): every rank steps its own block; the losses and the fitted
    model match the single-process fit, and the loss falls (darkening toward
    a black target)."""
    size, _, results = world4
    res = results["train"]
    assert all(np.isfinite(res["history"])) and res["history"][-1] < res["history"][0]
    np.testing.assert_allclose(res["history"], res["single_history"], rtol=1e-5)
    for k in LEAVES:
        np.testing.assert_allclose(res["fitted"][k], res["single_fitted"][k], atol=1e-5,
                                   rtol=1e-4, err_msg=f"{size} ranks: {k}")


def test_sharded_checkpoint_resume(world4):
    """fit(mesh=, checkpoint_dir=): rank 0 alone writes the whole state (the
    single process's file: every leaf and Adam moment, gathered in rank
    order); a resumed sharded run — each rank restoring its block — steps
    on as the uninterrupted single process does."""
    size, _, results = world4
    res = results["train"]
    assert res["files"] == ["step_00000001.pt", "step_00000002.pt"]
    assert res["saved"]["step"] == 2 and res["resumed_step"] == 2
    for k in LEAVES:
        np.testing.assert_allclose(res["saved"]["model"][k], res["single_fitted"][k],
                                   atol=1e-5, rtol=1e-4, err_msg=f"saved {k}")
        for m, got, want in zip(("exp_avg", "exp_avg_sq"), res["saved"]["moments"][k],
                                res["single_moments"][k]):
            assert got.shape == want.shape, (k, m)
            np.testing.assert_allclose(got, want, atol=GRAD_ATOL * float(np.abs(want).max()),
                                       rtol=GRAD_RTOL, err_msg=f"saved {k} {m}")
        np.testing.assert_allclose(res["resumed"][k], res["single_longer"][k], atol=1e-5,
                                   rtol=1e-4, err_msg=f"{size} ranks, resumed: {k}")
        assert not np.array_equal(res["resumed"][k], res["fitted"][k]), k


def test_sharded_stats_shapes_and_balance(world4):
    """8 tile rows over 4 ranks (they divide): stats of every band, and the
    frame bit for bit the single process's."""
    _, cases, results = world4
    res = results["stats"]
    _assert_matches_single(res, cases["stats"], "512 splats, 128 px", jax_too=False)
    for leaf in res["stats"].values():
        assert leaf.shape == (4,)
    assert int(res["stats"]["dropped_gaussians"].sum()) == 0
    assert int(res["stats"]["num_pairs"].sum()) > 0
    assert res["bitwise_repeatable"]
    # the binning-only path reports the render's per-band stats
    for k, v in res["binning_stats"].items():
        np.testing.assert_array_equal(v, res["stats"][k], err_msg=k)


def test_sharded_imbalanced_scene_reports_drops(world4):
    """All splats in the top band: the capacity cap is hit in that band only,
    and reported; a larger margin restores the single chip's image."""
    _, cases, results = world4
    drops = results["crowded_tight"]["stats"]["dropped_gaussians"]
    assert drops.sum() > 0 and (drops > 0).sum() <= 2
    roomy = results["crowded_roomy"]
    assert int(roomy["stats"]["dropped_gaussians"].sum()) == 0
    # bit for bit the port's single process (held to JAX by the cases above)
    _assert_matches_single(roomy, cases["crowded_roomy"], "crowded, margin 1.0", jax_too=False)


def test_all_to_all_send_overflow_reported(world4):
    _, _, results = world4
    assert int(results["a2a_overflow"]["stats"]["dropped_gaussians"].sum()) > 0


# -- the mesh helpers, in this process -------------------------------------------


def test_pad_and_local_batch_slice_equal_jax():
    from gaussian_splat_tpu.parallel import distributed as jax_distributed
    from gaussian_splat_tpu.parallel import mesh as jax_mesh
    from gaussian_splat_tpu_torch.parallel import distributed, mesh

    for n, m in ((10, 4), (12, 4), (1, 8), (0, 3), (1_000_000, 3)):
        assert mesh.pad_to_multiple(n, m) == jax_mesh.pad_to_multiple(n, m)
    # one process, outside any group: the whole axis, as JAX's one process
    for total in (1, 8, 12):
        assert distributed.local_batch_slice(total) == jax_distributed.local_batch_slice(total)


def test_make_mesh_refuses(monkeypatch):
    """Too few cards (for this host's ranks: LOCAL_WORLD_SIZE where a
    launcher set it), no process group to join, no GPU for device=None; a
    rank's card is its LOCAL_RANK on a host of several; and init_distributed
    with no address is a no-op."""
    from gaussian_splat_tpu_torch.parallel import distributed, mesh

    for var in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="CUDA devices are visible"):
        mesh.make_mesh(2, device="cuda")
    assert mesh.local_index(5) == 5
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    assert mesh.local_index(5) == 1
    with pytest.raises(ValueError, match="needs 3 cards on this host"):
        mesh.make_mesh(8, device="cuda")
    with pytest.raises(ValueError, match="no process group"):
        mesh.make_mesh(2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.make_mesh(2)
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.init_distributed() is False
