"""Checkpoints of the port's training state: round trip, retention, and a
resumed run that equals the uninterrupted one bit for bit on the CPU."""

import os

import numpy as np
import pytest
import torch

from gaussian_splat_tpu_torch import convert
from gaussian_splat_tpu_torch.config import RenderConfig, TrainConfig
from gaussian_splat_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_tpu_torch.ops.render import render
from gaussian_splat_tpu_torch.train import trainer
from gaussian_splat_tpu_torch.train.checkpoint import (
    MAX_TO_KEEP, latest_step, restore_checkpoint, save_checkpoint,
)
from gaussian_splat_tpu_torch.train.dataset import orbit_dataset
from gaussian_splat_tpu_torch.train.densify import init_densify_state

LEAVES = GaussianModel.LEAVES


def _model(seed, n=16):
    return convert.model_from_numpy(convert.random_leaves(seed, n, sh_degree=1), "cpu")


def _stepped_state(seed, steps=2):
    """A TrainState whose optimizer has taken `steps` updates."""
    state = trainer.create_train_state(_model(seed), TrainConfig())
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        for k in LEAVES:
            p = getattr(state.model, k)
            p.grad = torch.randn(p.shape, generator=gen)
        state.optimizer.step()
        state.step += 1
    return state


def test_train_state_round_trip(tmp_path):
    d = str(tmp_path / "ckpt")
    assert latest_step(d) is None
    assert restore_checkpoint(d, _stepped_state(0)) is None
    state = _stepped_state(0, steps=7)
    save_checkpoint(d, state)
    assert latest_step(d) == 7 and os.listdir(d) == ["step_00000007.pt"]

    other = trainer.create_train_state(_model(1), TrainConfig())
    restored = restore_checkpoint(d, other)
    assert restored is other and restored.step == 7
    for k in LEAVES:
        p, q = getattr(state.model, k), getattr(restored.model, k)
        assert torch.equal(p, q), k
        for moment in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(
                state.optimizer.state[p][moment], restored.optimizer.state[q][moment]
            ), (k, moment)
    assert [g["name"] for g in restored.optimizer.param_groups] == list(LEAVES)


def test_adc_state_round_trip_keeps_scores_and_the_jitter_stream(tmp_path):
    d = str(tmp_path / "ckpt")

    def adc_state(seed):
        m = _model(seed)
        rng = torch.Generator().manual_seed(seed)
        return trainer.AdcTrainState(
            model=m, optimizer=trainer.make_optimizer(m, TrainConfig()), step=3,
            densify=init_densify_state(16, "cpu")._replace(
                grad_score=torch.rand(16, generator=rng), ema_beta=0.8),
            jitter_rng=rng,
        )

    state = adc_state(0)
    save_checkpoint(d, state)
    next_draw = torch.randn(5, generator=state.jitter_rng)
    restored = restore_checkpoint(d, adc_state(1))
    assert restored.step == 3 and restored.densify.ema_beta == 0.8
    assert torch.equal(restored.densify.grad_score, state.densify.grad_score)
    assert torch.equal(torch.randn(5, generator=restored.jitter_rng), next_draw)


def test_newest_three_are_kept(tmp_path):
    d = str(tmp_path / "ckpt")
    state = _stepped_state(2, steps=0)
    for step in (1, 2, 3, 4, 5):
        state.step = step
        save_checkpoint(d, state)
    assert MAX_TO_KEEP == 3
    assert sorted(os.listdir(d)) == [f"step_{s:08d}.pt" for s in (3, 4, 5)]
    assert latest_step(d) == 5


def _adc_setup():
    cfg = RenderConfig(sh_degree=1)
    gt = convert.model_from_numpy(
        convert.random_leaves(1, 32, sh_degree=1, extent=0.8, scale_range=(0.05, 0.2)), "cpu")
    init = convert.model_from_numpy(
        convert.random_leaves(2, 32, sh_degree=1, extent=0.8, scale_range=(0.05, 0.2)), "cpu")
    ds = orbit_dataset(lambda cam: render(gt, cam, cfg).image, n_views=3, radius=3.0,
                       width=32, height=32, device="cpu")
    return cfg, init, ds


def test_adc_resume_equals_the_uninterrupted_run(tmp_path):
    """Views (numpy generator, replayed) and densify jitter (generator state
    in the checkpoint) continue as if the run had never stopped; the resumed
    run changes densify_every's phase relative to its own start, which must
    not matter."""
    cfg, init, ds = _adc_setup()
    kw = dict(densify_every=4, opacity_reset_every=5, victim_fraction=0.1, log_every=1, seed=7)
    whole, h_whole = trainer.fit_multiview_adc(
        init, ds, cfg, TrainConfig(num_steps=10), **kw)

    ck = str(tmp_path / "ck")
    _, h1 = trainer.fit_multiview_adc(
        init, ds, cfg, TrainConfig(num_steps=6, checkpoint_dir=ck, checkpoint_every=3), **kw)
    assert latest_step(ck) == 6  # saved after steps 3 and 6
    resumed, h2 = trainer.fit_multiview_adc(
        init, ds, cfg, TrainConfig(num_steps=10, checkpoint_dir=ck, checkpoint_every=3),
        resume=True, **kw)
    assert len(h2) == 4 and latest_step(ck) == 9
    # the first run stopped at 6 steps: densify_until = int(6 * 0.8) differs from
    # the whole run's, so compare where both densified alike (steps <= 4), i.e.
    # the loss history up to the checkpoint, and the resumed tail with the whole
    assert h1[:5] == h_whole[:5]
    assert np.isfinite(h2).all()

    # same hyperparameters on both sides of the stop: bit-identical to the end
    ck2 = str(tmp_path / "ck2")
    tc10 = TrainConfig(num_steps=10, checkpoint_dir=ck2, checkpoint_every=5)

    class Stop(Exception):
        pass

    real_save = trainer._maybe_checkpoint

    def save_then_stop(tc, state, due):
        real_save(tc, state, due)
        if due and state.step == 5:
            raise Stop

    trainer._maybe_checkpoint = save_then_stop
    try:
        with pytest.raises(Stop):
            trainer.fit_multiview_adc(init, ds, cfg, tc10, **kw)
    finally:
        trainer._maybe_checkpoint = real_save
    assert latest_step(ck2) == 5
    again, h_tail = trainer.fit_multiview_adc(init, ds, cfg, tc10, resume=True, **kw)
    assert h_tail == h_whole[5:]
    for k in LEAVES:
        assert torch.equal(getattr(again, k), getattr(whole, k)), k


def test_fit_saves_checkpoints_on_its_cadence(tmp_path):
    cfg, init, ds = _adc_setup()
    ck = str(tmp_path / "ck")
    trainer.fit(init, ds.camera(0), ds.target(0), cfg,
                TrainConfig(num_steps=6, checkpoint_dir=ck, checkpoint_every=2,
                            steps_per_dispatch=2))
    assert sorted(os.listdir(ck)) == [f"step_{s:08d}.pt" for s in (2, 4, 6)]
    state = trainer.create_train_state(init, TrainConfig())
    assert restore_checkpoint(ck, state).step == 6
