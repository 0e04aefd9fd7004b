"""The port's PLY writer: round trip through its reader, and the same bytes
as the JAX package's writer (native interleaver or numpy, whichever it takes)."""

import numpy as np
import pytest
import torch

from gaussian_splat_tpu.io import ply as jax_ply
from gaussian_splat_tpu.models.gaussians import GaussianModel as JaxModel
from gaussian_splat_tpu_torch import convert
from gaussian_splat_tpu_torch.io import ply as torch_ply
from gaussian_splat_tpu_torch.models.gaussians import GaussianModel


@pytest.mark.parametrize("sh_degree,n", [(0, 17), (1, 40), (3, 9), (2, 1)])
def test_save_round_trips_and_equals_the_jax_writer(tmp_path, sh_degree, n):
    leaves = convert.random_leaves(sh_degree, n, sh_degree=sh_degree)
    model = convert.model_from_numpy(leaves, "cpu")
    mine, theirs = tmp_path / "torch.ply", tmp_path / "jax.ply"
    torch_ply.save_gaussians(str(mine), model)
    jax_ply.save_gaussians(str(theirs), JaxModel.create(**leaves))
    assert mine.read_bytes() == theirs.read_bytes()

    back = torch_ply.load_gaussians(str(mine), device="cpu")
    assert back.sh_degree == sh_degree and back.num_gaussians == n
    for name in GaussianModel.LEAVES:
        assert torch.equal(getattr(back, name), getattr(model, name)), name
    # and the JAX reader takes the port's file
    jm = jax_ply.load_gaussians(str(mine))
    np.testing.assert_array_equal(np.asarray(jm.sh), leaves["sh"])


def test_save_takes_a_model_that_is_being_trained(tmp_path):
    model = convert.model_from_numpy(convert.random_leaves(0, 5), "cpu")
    model.means.sum().backward()  # parameters that require grad and hold one
    torch_ply.save_gaussians(str(tmp_path / "m.ply"), model)
    back = torch_ply.load_gaussians(str(tmp_path / "m.ply"), device="cpu")
    assert torch.equal(back.means, model.means.detach())
