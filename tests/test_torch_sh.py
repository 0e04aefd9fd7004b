"""Port eval_sh vs the JAX eval_sh on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splat_tpu.ops import sh as jax_sh
from gaussian_splat_tpu_torch.ops import sh as torch_sh


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh_matches_jax(degree):
    rng = np.random.default_rng(degree)
    n = 64
    sh = rng.standard_normal((n, 16, 3)).astype(np.float32)
    dirs = rng.standard_normal((n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    want = np.asarray(jax_sh.eval_sh(degree, jnp.asarray(sh), jnp.asarray(dirs)))
    got = torch_sh.eval_sh(degree, torch.from_numpy(sh), torch.from_numpy(dirs))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_constants_and_helpers():
    assert torch_sh.SH_C0 == jax_sh.SH_C0 and torch_sh.SH_C1 == jax_sh.SH_C1
    assert torch_sh.SH_C2 == jax_sh.SH_C2 and torch_sh.SH_C3 == jax_sh.SH_C3
    assert [torch_sh.num_sh_bases(d) for d in range(4)] == [1, 4, 9, 16]
    rgb = np.linspace(0, 1, 12, dtype=np.float32).reshape(4, 3)
    np.testing.assert_allclose(
        torch_sh.rgb_to_sh_dc(torch.from_numpy(rgb)).numpy(),
        np.asarray(jax_sh.rgb_to_sh_dc(jnp.asarray(rgb))), atol=1e-6,
    )
    with pytest.raises(ValueError):
        torch_sh.eval_sh(4, torch.zeros(1, 25, 3), torch.zeros(1, 3))
