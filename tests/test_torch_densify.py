"""Adaptive density control of the port against the JAX one, on the same
numpy model, scores and jitter noise: victim and donor indices are
integer-exact, the respawned parameters agree to float32 rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splat_tpu.config import TrainConfig as JaxTrainConfig
from gaussian_splat_tpu.models.gaussians import GaussianModel as JaxModel
from gaussian_splat_tpu.train import densify as jax_adc
from gaussian_splat_tpu.train.trainer import make_optimizer as jax_make_optimizer
from gaussian_splat_tpu_torch import convert
from gaussian_splat_tpu_torch.config import TrainConfig
from gaussian_splat_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_tpu_torch.train import densify as adc
from gaussian_splat_tpu_torch.train.trainer import make_optimizer

LEAVES = GaussianModel.LEAVES


def _setup(seed, n, ties=False):
    leaves = convert.random_leaves(seed, n, sh_degree=1)
    rng = np.random.default_rng(seed + 50)
    score = rng.uniform(0, 1, n).astype(np.float32)
    if ties:  # equal opacities and equal scores: the order of ties decides
        leaves["opacity_logits"] = np.round(leaves["opacity_logits"]).astype(np.float32)
        score = np.round(score * 4).astype(np.float32) / 4
    return leaves, score


def _jax_densify(leaves, score, noise, victim_fraction):
    """The reference's densify_step with its normal draw replaced by `noise`."""
    real = jax.random.normal
    jax.random.normal = lambda key, shape: jnp.asarray(noise).reshape(shape)
    try:
        return jax_adc.densify_step(
            JaxModel.create(**leaves), jax_adc.DensifyState(jnp.asarray(score)),
            jax.random.PRNGKey(0), victim_fraction=victim_fraction,
        )
    finally:
        jax.random.normal = real


@pytest.mark.parametrize("seed,n,fraction,ties", [
    (0, 100, 0.05, False), (1, 64, 0.1, True), (2, 30, 0.01, False), (3, 200, 0.2, True),
])
def test_densify_step_matches_jax_with_shared_noise(seed, n, fraction, ties):
    leaves, score = _setup(seed, n, ties)
    v = max(1, int(n * fraction))
    noise = np.random.default_rng(seed).standard_normal((v, 3)).astype(np.float32)
    jm, jstate, jmask = _jax_densify(leaves, score, noise, fraction)

    tm = convert.model_from_numpy(leaves, "cpu")
    tstate = convert.densify_state_from_numpy(score, device="cpu")
    out, new_state, mask = adc.densify_step(
        tm, tstate, torch.from_numpy(noise), victim_fraction=fraction
    )
    assert out is tm  # in place
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))  # integer-exact
    assert int(mask.sum()) == 2 * v
    np.testing.assert_array_equal(
        new_state.grad_score.numpy(), np.asarray(jstate.grad_score)
    )
    assert new_state.ema_beta == jstate.ema_beta
    untouched = ~mask.numpy()
    for k in LEAVES:
        got, want = getattr(tm, k).detach().numpy(), np.asarray(getattr(jm, k))
        np.testing.assert_array_equal(got[untouched], leaves[k][untouched], err_msg=k)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=k)


def test_densify_draws_from_a_generator_and_checks_noise_shape():
    leaves, score = _setup(4, 40)
    runs = []
    for _ in range(2):
        tm = convert.model_from_numpy(leaves, "cpu")
        st = convert.densify_state_from_numpy(score, device="cpu")
        adc.densify_step(tm, st, torch.Generator().manual_seed(5), victim_fraction=0.1)
        runs.append(tm.means.detach().clone())
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], torch.from_numpy(leaves["means"]))
    with pytest.raises(ValueError, match="noise"):
        adc.densify_step(tm, st, torch.zeros(3, 3), victim_fraction=0.1)


def test_update_scores_matches_jax():
    rng = np.random.default_rng(0)
    g = rng.standard_normal((25, 2)).astype(np.float32)
    ts, js = adc.init_densify_state(25, "cpu"), jax_adc.init_densify_state(25)
    for _ in range(3):
        ts, js = adc.update_scores(ts, torch.from_numpy(g)), jax_adc.update_scores(js, jnp.asarray(g))
    np.testing.assert_allclose(ts.grad_score.numpy(), np.asarray(js.grad_score), rtol=1e-6)
    assert float(ts.grad_score.min()) > 0


@pytest.mark.parametrize("ceiling", [0.01, 0.3])
def test_reset_opacity_matches_jax(ceiling):
    leaves, _ = _setup(5, 50)
    leaves["opacity_logits"] = np.linspace(-8, 4, 50).astype(np.float32)
    tm = convert.model_from_numpy(leaves, "cpu")
    out = adc.reset_opacity(tm, ceiling)
    want = jax_adc.reset_opacity(JaxModel.create(**leaves), ceiling)
    assert out is tm
    np.testing.assert_allclose(
        tm.opacity_logits.detach().numpy(), np.asarray(want.opacity_logits), rtol=1e-6
    )
    assert float(tm.opacities.detach().max()) <= ceiling + 1e-6
    low = leaves["opacity_logits"] < -6
    np.testing.assert_array_equal(
        tm.opacity_logits.detach().numpy()[low], leaves["opacity_logits"][low]
    )


def test_reset_opt_rows_matches_jax():
    n = 30
    leaves, _ = _setup(6, n)
    rng = np.random.default_rng(1)
    grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in leaves.items()}
    mask = np.zeros(n, bool)
    mask[[3, 17, 29]] = True

    jm = JaxModel.create(**leaves)
    tx = jax_make_optimizer(JaxTrainConfig())
    jopt = tx.init(jm)
    _, jopt = tx.update(JaxModel.create(**grads), jopt, jm)
    jopt = jax_adc.reset_opt_rows(jopt, jnp.asarray(mask))

    tm = convert.model_from_numpy(leaves, "cpu")
    opt = make_optimizer(tm, TrainConfig())
    for k in LEAVES:
        getattr(tm, k).grad = torch.from_numpy(grads[k])
    opt.step()
    assert adc.reset_opt_rows(opt, torch.from_numpy(mask)) is opt
    for k in LEAVES:
        adam = jopt.inner_states[k].inner_state[0]
        state = opt.state[getattr(tm, k)]
        for mine, theirs in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            got = state[mine].numpy()
            np.testing.assert_allclose(
                got, np.asarray(getattr(theirs, k)), rtol=1e-6, atol=1e-12, err_msg=k
            )
            assert not got[mask].any() and np.abs(got[~mask]).min() > 0
        assert float(state["step"]) == 1.0  # the update count is not reset
