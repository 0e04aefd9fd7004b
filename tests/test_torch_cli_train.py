"""`cli train` of the port, end to end on the CPU: PLY in, PNG target, a few
steps, PLY out, checkpoints on disk."""

import os

import numpy as np
import torch
from PIL import Image

from gaussian_splat_tpu_torch import cli
from gaussian_splat_tpu_torch.io.ply import load_gaussians
from gaussian_splat_tpu_torch.train.checkpoint import latest_step

PLY = os.path.join(os.path.dirname(__file__), "golden", "scene.ply")


def test_cli_train_end_to_end(tmp_path, capsys):
    target = tmp_path / "target.png"
    rc = cli.main([
        "render", PLY, "--out", str(target), "--width", "48", "--height", "32",
        "--radius", "3.0", "--azimuth", "10.0", "--device", "cpu",
    ])
    assert rc == 0
    out, ck = tmp_path / "trained.ply", tmp_path / "ck"
    rc = cli.main([
        "train", PLY, "--target", str(target), "--out", str(out), "--steps", "3",
        "--radius", "3.0", "--azimuth", "40.0", "--checkpoint-dir", str(ck),
        "--device", "cpu",
    ])
    printed = capsys.readouterr().out
    assert rc == 0 and "trained 3 steps on cpu" in printed and "step 0: loss" in printed
    before, after = load_gaussians(PLY, device="cpu"), load_gaussians(str(out), device="cpu")
    assert after.num_gaussians == before.num_gaussians == 2000
    assert torch.isfinite(after.means).all()
    assert not torch.equal(after.opacity_logits, before.opacity_logits)
    assert latest_step(str(ck)) is None  # checkpoint_every (500) not reached in 3 steps
    assert np.asarray(Image.open(target)).shape == (32, 48, 3)


def test_cli_train_is_listed_and_needs_a_target(capsys):
    import pytest

    with pytest.raises(SystemExit):
        cli.main(["train", PLY])
    assert "--target" in capsys.readouterr().err
