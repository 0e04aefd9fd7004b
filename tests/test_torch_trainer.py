"""The training slice as a whole, on the CPU: the port's trainer against the
JAX trainer from the SAME state — parameters, Adam moments and update count
carried across by `convert` — on `jnp_tile` / `torch_tile` at 32×32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splat_tpu.camera import Camera as JaxCamera
from gaussian_splat_tpu.config import RenderConfig as JaxConfig
from gaussian_splat_tpu.config import TrainConfig as JaxTrainConfig
from gaussian_splat_tpu.models.gaussians import GaussianModel as JaxModel
from gaussian_splat_tpu.ops.render import render as jax_render
from gaussian_splat_tpu.train import trainer as jax_trainer
from gaussian_splat_tpu.train.dataset import ViewDataset as JaxViewDataset
from gaussian_splat_tpu_torch import convert
from gaussian_splat_tpu_torch.config import RenderConfig, TrainConfig
from gaussian_splat_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_tpu_torch.ops.render import render
from gaussian_splat_tpu_torch.train import trainer
from gaussian_splat_tpu_torch.train.dataset import ViewDataset

W = H = 32
LEAVES = GaussianModel.LEAVES
TC_KW = dict(num_steps=5, lr_means=1e-3, lr_means_final=1e-5, lr_decay_steps=10)
LRS = dict(means=1e-3, quats=1e-3, log_scales=5e-3, opacity_logits=5e-2, sh=2.5e-3)


def _cameras(n_views=1):
    jcs = [
        JaxCamera.from_lookat(
            (3 * np.sin(a), 0.3, -3 * np.cos(a)), (0, 0, 0), (0, 1, 0), 60.0, W, H
        )
        for a in np.linspace(0.0, 1.0, n_views)
    ]
    tcs = [
        convert.camera_from_numpy(
            np.asarray(c.viewmat), c.fx, c.fy, c.cx, c.cy, W, H, device="cpu"
        )
        for c in jcs
    ]
    return jcs, tcs


def _scene(seed, n=40):
    gt = convert.random_leaves(seed, n, sh_degree=1, extent=0.8, scale_range=(0.05, 0.2))
    init = convert.random_leaves(seed + 1, n, sh_degree=1, extent=0.8, scale_range=(0.05, 0.2))
    return gt, init


def _jax_targets(gt, jcs):
    cfg = JaxConfig(backend="jnp_tile", sh_degree=1)
    model = JaxModel.create(**gt)
    return [np.asarray(jax_render(model, c, cfg).image) for c in jcs]


def _adam_state(opt_state, name):
    """optax's ScaleByAdamState of one leaf's group."""
    return opt_state.inner_states[name].inner_state[0]


def test_train_steps_match_jax_from_carried_state():
    """Two JAX steps make a mid-run state; it is carried across, and three more
    steps are taken on both sides.

    Tolerance. Losses: rtol 2e-5 (float32 sums in another order). Parameters:
    Adam's update is lr·m̂/(√v̂+ε), which turns a gradient's RELATIVE error
    into the update's, so the bound is stated in updates: an element may
    differ by a thousandth of one update per step, atol 1e-3·lr·(steps).
    Elements whose gradient is rounding noise (RMS gradient √v̂ below 1e-7)
    are left out: there m̂/√v̂ is the ratio of two noises and may even differ
    in sign between two correct implementations."""
    gt, init = _scene(0)
    jcs, tcs = _cameras()
    target = _jax_targets(gt, jcs)[0]
    jtc, ttc = JaxTrainConfig(**TC_KW), TrainConfig(**TC_KW)
    jcfg = JaxConfig(backend="jnp_tile", sh_degree=1)
    tcfg = RenderConfig(backend="torch_tile", sh_degree=1)

    jstep = jax_trainer.make_train_step(jcs[0], jcfg, jtc, donate=False)
    jstate = jax_trainer.create_train_state(JaxModel.create(**init), jtc)
    for _ in range(2):
        jstate, _ = jstep(jstate, jnp.asarray(target))

    # carry the mid-run state across
    tmodel = convert.model_from_numpy(
        {k: np.asarray(getattr(jstate.model, k)) for k in LEAVES}, device="cpu"
    )
    tstate = trainer.TrainState(
        model=tmodel, optimizer=trainer.make_optimizer(tmodel, ttc), step=int(jstate.step)
    )
    convert.load_adam_state(
        tstate.optimizer, tmodel,
        mu={k: np.asarray(getattr(_adam_state(jstate.opt_state, k).mu, k)) for k in LEAVES},
        nu={k: np.asarray(getattr(_adam_state(jstate.opt_state, k).nu, k)) for k in LEAVES},
        count=int(_adam_state(jstate.opt_state, "means").count),
    )
    assert tstate.step == 2
    tstep = trainer.make_train_step(tcs[0], tcfg, ttc)

    steps = 3
    jlosses, tlosses = [], []
    for _ in range(steps):
        jstate, jl = jstep(jstate, jnp.asarray(target))
        tstate, tl = tstep(tstate, torch.from_numpy(target))
        jlosses.append(float(jl))
        tlosses.append(float(tl))
    np.testing.assert_allclose(tlosses, jlosses, rtol=2e-5)
    assert tstate.step == int(jstate.step) == 5

    t = int(jstate.step)
    for k in LEAVES:
        nu = np.asarray(getattr(_adam_state(jstate.opt_state, k).nu, k))
        rms_grad = np.sqrt(nu / (1.0 - 0.999**t))
        live = rms_grad > 1e-7
        assert live.mean() > 0.3, k
        got = getattr(tstate.model, k).detach().numpy()
        want = np.asarray(getattr(jstate.model, k))
        np.testing.assert_allclose(
            got[live], want[live], rtol=0, atol=1e-3 * LRS[k] * steps, err_msg=k
        )
        # and the moments themselves, where they stand above rounding
        exp_avg = tstate.optimizer.state[getattr(tstate.model, k)]["exp_avg"].numpy()
        mu = np.asarray(getattr(_adam_state(jstate.opt_state, k).mu, k))
        np.testing.assert_allclose(
            exp_avg, mu, rtol=3e-3, atol=5e-6 * max(np.abs(mu).max(), 1e-30) + 1e-9,
            err_msg=f"{k} exp_avg",
        )


def test_fit_multiview_losses_match_jax():
    """Same views drawn (numpy's generator on both sides), same losses."""
    gt, init = _scene(2)
    jcs, tcs = _cameras(2)
    targets = _jax_targets(gt, jcs)
    kw = dict(TC_KW, num_steps=4)
    jds = JaxViewDataset.from_views(list(zip(jcs, targets)))
    tds = ViewDataset.from_views(list(zip(tcs, targets)))
    assert tds.num_views == 2 and tds.device.type == "cpu"
    with pytest.raises(ValueError, match="share resolution"):
        ViewDataset.from_views([(tcs[0], targets[0]), (tcs[1].resized(16, 16), targets[1])])
    np.testing.assert_array_equal(tds.target(1).numpy(), targets[1])
    _, jh = jax_trainer.fit_multiview(
        JaxModel.create(**init), jds, JaxConfig(backend="jnp_tile", sh_degree=1),
        JaxTrainConfig(**kw), seed=3, log_every=1,
    )
    _, th = trainer.fit_multiview(
        convert.model_from_numpy(init, "cpu"), tds,
        RenderConfig(backend="torch_tile", sh_degree=1), TrainConfig(**kw),
        seed=3, log_every=1,
    )
    assert len(th) == len(jh) == 4
    np.testing.assert_allclose(th, jh, rtol=2e-4)


def _torch_fit_setup(seed=4):
    gt, init = _scene(seed, n=30)
    _, tcs = _cameras()
    cfg = RenderConfig(sh_degree=1)
    with torch.no_grad():
        target = render(convert.model_from_numpy(gt, "cpu"), tcs[0], cfg).image
    return convert.model_from_numpy(init, "cpu"), tcs[0], target, cfg


def test_steps_per_dispatch_matches_stepwise_and_logs_alike():
    model, cam, target, cfg = _torch_fit_setup()
    m1, h1 = trainer.fit(model, cam, target, cfg, TrainConfig(num_steps=4), log_every=2)
    m4, h4 = trainer.fit(
        model, cam, target, cfg, TrainConfig(num_steps=4, steps_per_dispatch=4), log_every=2
    )
    for k in LEAVES:
        assert torch.equal(getattr(m1, k), getattr(m4, k)), k
    assert len(h1) == 3 and len(h4) == 1 and h4[-1] == h1[-1]


def test_fit_copies_the_model_and_lowers_the_loss():
    model, cam, target, cfg = _torch_fit_setup()
    before = {k: getattr(model, k).detach().clone() for k in LEAVES}
    seen = []
    fitted, history = trainer.fit(
        model, cam, target, cfg, TrainConfig(num_steps=12, lr_opacities=0.1),
        log_every=3, callback=lambda i, loss, state: seen.append((i, state.step)),
    )
    assert fitted is not model
    for k in LEAVES:
        assert torch.equal(getattr(model, k), before[k]), k
        assert not torch.equal(getattr(fitted, k), before[k]), k
    assert history[-1] < history[0]
    assert seen == [(0, 1), (3, 4), (6, 7), (9, 10), (11, 12)]


def test_mesh_is_refused_until_the_multi_gpu_slice():
    """The multi-GPU slice is here: `mesh=` is taken, not refused. On a mesh
    of one gloo rank in this process, fit(mesh=) renders through
    render_sharded and fits what the single-process fit fits, bit for bit
    (tests/test_torch_parallel.py runs 2 and 4 ranks)."""
    import socket

    import torch.distributed as dist

    from gaussian_splat_tpu_torch.parallel.mesh import make_mesh, shard_model

    model, cam, target, cfg = _torch_fit_setup()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mesh = make_mesh(1, device="cpu", rank=0, init_method=f"tcp://127.0.0.1:{port}")
    try:
        tc = TrainConfig(num_steps=2)
        sharded, h_mesh = trainer.fit(shard_model(model, mesh), cam, target, cfg, tc,
                                      mesh=mesh, log_every=1)
        single, h_single = trainer.fit(model, cam, target, cfg, tc, log_every=1)
        assert h_mesh == h_single and h_mesh[-1] < h_mesh[0]
        for k in LEAVES:
            assert torch.equal(getattr(sharded, k), getattr(single, k)), k
        assert callable(trainer.make_multiview_train_step(None, cfg, TrainConfig(), mesh=mesh))
    finally:
        dist.destroy_process_group()


def test_optimizer_groups_follow_the_reference():
    model = convert.model_from_numpy(convert.random_leaves(0, 5, sh_degree=1), "cpu")
    tc = TrainConfig()
    opt = trainer.make_optimizer(model, tc)
    assert isinstance(opt, torch.optim.Adam)
    assert [g["name"] for g in opt.param_groups] == list(LEAVES)
    want = dict(means=tc.lr_means, quats=tc.lr_quats, log_scales=tc.lr_scales,
                opacity_logits=tc.lr_opacities, sh=tc.lr_sh)
    for g in opt.param_groups:
        assert g["lr"] == want[g["name"]] and g["params"][0] is getattr(model, g["name"])
        assert g["betas"] == (0.9, 0.999) and g["eps"] == 1e-8
        assert g["weight_decay"] == 0 and not g["amsgrad"]
    trainer.set_position_lr(opt, tc, 30_000)
    assert opt.param_groups[0]["lr"] == pytest.approx(tc.lr_means_final)
    assert opt.param_groups[1]["lr"] == tc.lr_quats


def test_sh_warmup_masks_bands_like_jax():
    rng = np.random.default_rng(0)
    leaves = convert.random_leaves(0, 8, sh_degree=3)
    leaves["sh"] = rng.standard_normal(leaves["sh"].shape).astype(np.float32)
    tm, jm = convert.model_from_numpy(leaves, "cpu"), JaxModel.create(**leaves)
    for step in (0, 9, 10, 25, 30, 1000):
        got = trainer.apply_sh_warmup(tm, step, TrainConfig(sh_warmup_every=10))
        want = jax_trainer.apply_sh_warmup(jm, jnp.int32(step), JaxTrainConfig(sh_warmup_every=10))
        np.testing.assert_array_equal(got.sh.detach().numpy(), np.asarray(want.sh))
        assert got.means is tm.means
    assert trainer.apply_sh_warmup(tm, 0, TrainConfig()) is tm  # off by default
    # the model is untouched and the gradient reaches the active bands only
    view = trainer.apply_sh_warmup(tm, 10, TrainConfig(sh_warmup_every=10))
    view.sh.sum().backward()
    assert torch.equal(tm.sh.detach(), torch.from_numpy(leaves["sh"]))
    assert float(tm.sh.grad[:, :4].min()) == 1.0 and not tm.sh.grad[:, 4:].any()


def test_load_adam_state_refuses_other_shapes():
    model = convert.model_from_numpy(convert.random_leaves(0, 5), "cpu")
    opt = trainer.make_optimizer(model, TrainConfig())
    zeros = {k: np.zeros(getattr(model, k).shape, np.float32) for k in LEAVES}
    convert.load_adam_state(opt, model, zeros, zeros, count=4)
    assert float(opt.state[model.means]["step"]) == 4.0
    bad = dict(zeros, sh=np.zeros((5, 4, 3), np.float32))
    with pytest.raises(ValueError, match="sh"):
        convert.load_adam_state(opt, model, bad, zeros, count=0)
