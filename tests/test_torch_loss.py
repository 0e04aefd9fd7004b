"""The port's photometric loss against the JAX one — values and gradients on
the same numpy images — and the position learning-rate schedule against
optax's. Float32 on both sides, sums of ~10^4 terms in another order:
values to rtol 2e-6 + atol 1e-6, gradients to rtol 1e-4 + atol 1e-8 (an
image gradient of a mean loss is ~1e-4 per pixel)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaussian_splat_tpu.config import TrainConfig as JaxTrainConfig
from gaussian_splat_tpu.train import loss as jax_loss
from gaussian_splat_tpu.train.trainer import make_optimizer as jax_make_optimizer
from gaussian_splat_tpu_torch.config import TrainConfig
from gaussian_splat_tpu_torch.train import loss as torch_loss
from gaussian_splat_tpu_torch.train.trainer import position_lr


def _images(seed, h=37, w=53):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    return a, b


def test_window_and_filter_match_jax():
    np.testing.assert_array_equal(
        torch_loss._gaussian_window_1d(11), jax_loss._gaussian_window_1d(11)
    )
    a, _ = _images(0)
    w1 = torch_loss._gaussian_window_1d(11)
    got = torch_loss._filter2d(torch.from_numpy(a), w1)
    want = jax_loss._filter2d(jnp.asarray(a), w1)
    assert got.shape == a.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name,kw", [
    ("l1", {}), ("ssim", {}), ("photometric_loss", {}),
    ("photometric_loss", {"ssim_weight": 0.0}),
    ("photometric_loss", {"ssim_weight": 0.7}),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_loss_value_and_gradient_match_jax(name, kw, seed):
    a, b = _images(seed)
    ta = torch.from_numpy(a).requires_grad_()
    got = getattr(torch_loss, name)(ta, torch.from_numpy(b), **kw)
    got.backward()
    jfn = getattr(jax_loss, name)
    want, want_grad = jax.value_and_grad(lambda x: jfn(x, jnp.asarray(b), **kw))(
        jnp.asarray(a)
    )
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=2e-6, atol=1e-6)
    np.testing.assert_allclose(
        ta.grad.numpy(), np.asarray(want_grad), rtol=1e-4, atol=1e-8
    )
    assert float(np.abs(np.asarray(want_grad)).max()) > 1e-6


def test_loss_sanity():
    a, b = _images(2, 32, 32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert float(torch_loss.ssim(ta, ta)) > 0.9999
    assert float(torch_loss.ssim(ta, tb)) < float(torch_loss.ssim(ta, ta))
    assert abs(float(torch_loss.photometric_loss(ta, ta))) < 1e-5
    assert float(torch_loss.photometric_loss(ta, torch.zeros_like(ta))) > 0.01


@pytest.mark.parametrize("kw", [
    {},  # the defaults: 1.6e-4 -> 1.6e-6 over 30 000 updates
    {"lr_means": 1e-2, "lr_means_final": 1e-6, "lr_decay_steps": 100},
    {"lr_means": 1e-4, "lr_means_final": 1e-3, "lr_decay_steps": 50},  # rising
    {"lr_means_final": 0.0},  # no decay
    {"lr_means": 2e-4, "lr_means_final": 2e-4},
])
def test_position_lr_matches_optax(kw):
    """`position_lr(tc, count)` is the rate optax applies to the means on the
    update after `count` updates: read off optax by the size of an Adam
    update with constant gradient (|update| = lr exactly up to eps)."""
    jtc = JaxTrainConfig(**kw)
    ttc = TrainConfig(**kw)
    steps = jtc.lr_decay_steps or 30_000
    counts = sorted({0, 1, 2, steps // 3, steps - 1, steps, steps + 7, 3 * steps})
    if jtc.lr_means_final and jtc.lr_means_final != jtc.lr_means:
        schedule = optax.exponential_decay(
            init_value=jtc.lr_means, transition_steps=steps,
            decay_rate=jtc.lr_means_final / jtc.lr_means, end_value=jtc.lr_means_final,
        )
        want = [float(schedule(c)) for c in counts]
    else:
        want = [jtc.lr_means] * len(counts)
    got = [position_lr(ttc, c) for c in counts]
    np.testing.assert_allclose(got, want, rtol=2e-5)

    # and through the optimizer the reference really builds
    from gaussian_splat_tpu.models.gaussians import GaussianModel as JaxModel

    model = JaxModel.random(jax.random.PRNGKey(0), 4, sh_degree=0)
    tx = jax_make_optimizer(jtc)
    state = tx.init(model)
    g = jax.tree_util.tree_map(jnp.ones_like, model)
    for c in range(3):
        updates, state = tx.update(g, state, model)
        np.testing.assert_allclose(
            float(jnp.abs(updates.means).mean()), position_lr(ttc, c), rtol=1e-4
        )
