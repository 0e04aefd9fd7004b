"""The plain reference: its pieces against plain autograd at a tiny size."""

import json

import torch

from conftest import ROOT, TINY
from splatbench import scene
from splatbench.reference import render as ref
from splatbench.reference import train as ref_train

CFG = {**json.loads((ROOT / "splatbench/configs/truck.json").read_text()), **TINY}


def _dense(leaves, cam, s):
    """Every splat at every pixel, front to back: the reference's semantics
    with no fragments and no bands, differentiated by autograd."""
    feat, layout = ref.project(leaves, cam, s, torch.float64)
    order = torch.argsort(layout.rank)
    order = order[layout.valid[order]]
    ys, xs = torch.meshgrid(torch.arange(cam.height), torch.arange(cam.width), indexing="ij")
    px, py = xs.reshape(-1, 1) + 0.5, ys.reshape(-1, 1) + 0.5
    dx, dy = px - feat.mx[order], py - feat.my[order]
    sig = 0.5 * feat.a[order] * dx * dx + feat.b[order] * dx * dy + 0.5 * feat.c[order] * dy * dy
    keep = (sig >= 0) & (sig <= feat.bound[order])
    alpha = torch.where(keep, (feat.op[order] * torch.exp(-sig)).clamp_max(s["alpha_clamp"]), 0.0)
    t = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1 - alpha[:, :-1]], 1), 1)
    w = t * alpha
    col = torch.stack([feat.r, feat.g, feat.bl], -1)[order]
    return (w @ col).view(cam.height, cam.width, 3)


def test_fragments_equal_the_dense_sum():
    leaves = scene.make_splats(CFG, 3, "cpu")
    cam = scene.cameras(CFG, "orbit")[10]
    s = scene.render_settings(CFG)
    img, counts = ref.render(leaves, cam, s, counts=True)
    assert torch.allclose(img, _dense(leaves, cam, s), atol=1e-10)
    assert counts["pairs"] > 0 and counts["kept_steps"] > 0
    assert counts["steps"] >= counts["kept_steps"]


def test_band_by_band_gradient_equals_autograd(monkeypatch):
    monkeypatch.setattr(ref, "FRAGMENTS_PER_BAND", 500)  # many bands
    monkeypatch.setattr(ref_train, "PROJECT_ROWS", 700)  # many blocks
    leaves = scene.make_splats(CFG, 4, "cpu")
    cam = scene.cameras(CFG, "train")[3]
    target = scene.make_targets(CFG, 4, "cpu", 4)[3]
    s = scene.render_settings(CFG)
    loss, grads, _ = ref_train.loss_and_grads(leaves, cam, target, s, torch.float64, 0.2)
    want = {k: v.double().requires_grad_() for k, v in leaves.items()}
    img = _dense(want, cam, s)
    direct = ref_train.photometric_loss(img, target.double(), 0.2)
    direct.backward()
    assert abs(loss - float(direct.detach())) < 1e-12
    for k in scene.LEAVES:
        assert torch.allclose(grads[k].double(), want[k].grad, rtol=1e-6, atol=1e-12), k
