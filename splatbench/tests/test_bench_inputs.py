"""The generator and the yardstick's counts."""

import json

import pytest
import torch

from conftest import ROOT, TINY
from splatbench import costs, scene

CFG = {**json.loads((ROOT / "splatbench/configs/truck.json").read_text()), **TINY}


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3])
def test_same_seed_same_splats(seed):
    a = scene.make_splats(CFG, seed, "cpu")
    b = scene.make_splats(CFG, seed, "cpu")
    for k in scene.LEAVES:
        assert torch.equal(a[k], b[k])
    c = scene.make_splats(CFG, seed + 1, "cpu")
    assert not torch.equal(a["means"], c["means"])


def test_rows_made_alone_equal_the_whole(monkeypatch):
    monkeypatch.setattr(scene, "BLOCK_ROWS", 1024)
    whole = scene.make_splats(CFG, 11, "cpu")
    for rows in [(0, 700), (1000, 2100), (2047, 3000)]:
        part = scene.make_splats(CFG, 11, "cpu", rows=rows)
        for k in scene.LEAVES:
            assert torch.equal(part[k], whole[k][rows[0]:rows[1]])


def test_regions_hold_the_same_rows_for_every_seed():
    bounds = scene.region_bounds(CFG["scene"]["regions"], CFG["N"])
    assert bounds[0] == 0 and bounds[-1] == CFG["N"]
    assert bounds == scene.region_bounds(CFG["scene"]["regions"], CFG["N"])


def test_targets_views_and_cameras_follow_the_seed():
    t1 = scene.make_targets(CFG, 5, "cpu", 3)
    assert t1.shape == (3, CFG["height"], CFG["width"], 3)
    assert torch.equal(t1, scene.make_targets(CFG, 5, "cpu", 3))
    assert 0.0 <= float(t1.min()) and float(t1.max()) <= 1.0
    v = scene.view_sequence(5, 32, 100)
    assert (v == scene.view_sequence(5, 32, 100)).all() and v.max() < 32
    cams = scene.cameras(CFG, "orbit")
    assert len(cams) == CFG["cameras"]["orbit"]["count"]
    # the camera looks at its target: the target lies on the optical axis
    tgt = torch.tensor([*CFG["cameras"]["orbit"]["target"], 1.0])
    p = cams[7].viewmat @ tgt
    assert abs(float(p[0])) < 1e-4 and abs(float(p[1])) < 1e-4 and float(p[2]) > 0


def test_kernel_costs_equal_hand_counts():
    c = {"pairs": 10, "steps": 1000, "kept_steps": 100, "cells": 40, "big_rows": 2}
    k = costs.kernel_costs(c, n=5, width=64, height=32)  # 2 x 2 tiles
    assert k["raster_fwd"].bytes == 5 * 48 + 10 * 4 + 2 * 4 * 4 + 64 * 32 * 20
    assert k["raster_fwd"].flops == 100 * 9 + 100 * 14
    assert k["raster_bwd"].bytes == 5 * 48 + 10 * 4 + 3 * 4 * 4 + 64 * 32 * 40 + 10 * 48
    assert k["raster_bwd"].flops == 100 * 9 + 100 * 58
    assert k["segsum"].bytes == 10 * 52 + 6 * 4 + 5 * 48 and k["segsum"].flops == 120
    assert k["rank_perm"].bytes == 10 * 4 + 40 + 2 * 4 + 6 * 4 + 10 * 4
    assert k["raster_fwd"].attainable_ms() == max(k["raster_fwd"].bytes / 3.35e9,
                                                  k["raster_fwd"].flops / 67e9)


def test_step_and_frame_flops_equal_hand_counts():
    c = {"pairs": 10, "steps": 1000, "kept_steps": 100}
    per_splat = 277 + 13 + 7 + 50 + 16 * 6 + 6
    assert costs.splat_forward_flops(5, 3) == 5 * per_splat
    assert costs.params_per_splat(3) == 59
    frame = 5 * per_splat + 100 * 9 + 100 * 14 + 64 * 32 * 18
    assert costs.frame_flops(c, 5, 3, 64, 32) == frame
    step = (3 * 5 * per_splat + 100 * 9 + 100 * 14 + 100 * 9 + 100 * 58 + 120
            + 64 * 32 * 3 * 244 * 3 + 5 * 59 * 12)
    assert costs.step_flops(c, 5, 3, 64, 32) == step
