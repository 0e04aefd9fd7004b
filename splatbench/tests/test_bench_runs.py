"""Whole runs of the harness at a tiny size on the CPU, through the port's
plain CPU path (the only caller of that path here): sound runs come out
correct, the control and every planted fault come out not correct."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, TINY
from splatbench import control, run

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2**31 + 12345


def _tiny(cell, fault=None, trace=False):
    return run.run_cell(cell, SEED, 0.3, trace, device="cpu", overrides=TINY, fault=fault)


def _fails(numbers, limits):
    return any(numbers[k] > limits[k] for k in limits)


@pytest.mark.parametrize("cell", ["truck.view", "truck.train"])
def test_sound_run_is_correct(cell):
    line = _tiny(cell)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    names = {m["name"] for m in run.end_to_end(BENCH, cell)}
    assert set(line["metrics"]) == names


@pytest.mark.parametrize("cell,fault", [
    ("truck.view", "altered_answer"), ("truck.view", "stale_frame"),
    ("truck.train", "state_unchanged"), ("truck.train", "half_batch"),
    ("truck.view", "stats_stale"), ("truck.train", "stats_lost"),
])
def test_planted_fault_is_not_correct(cell, fault):
    assert not _tiny(cell, fault)["correct"]


@pytest.mark.parametrize("cell", ["truck.view", "truck.train"])
def test_control_is_not_correct(cell):
    _, _, _, limits = run.resolve(ROOT, BENCH, cell)
    numbers = control.control_numbers(cell, SEED, "cpu", overrides=TINY)
    assert _fails(numbers, limits), numbers


def test_traced_run_reads_its_layer_metrics():
    line = _tiny("truck.view", trace=True)
    assert line["correct"]
    assert "binning.pairs_per_splat.view" in line["metrics"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_loaded_modules_hold_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from splatbench import run, control\n"
        "run.run_cell('truck.view', 3, 0.2, False, device='cpu', overrides=%r)\n"
        "print(run.forbidden_loaded())\n" % (str(ROOT), TINY))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "gaussian_splat_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxlike.sub", object())
    assert run.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "gaussian_splat_tpu.ops", object())
    assert run.forbidden_loaded() == ["gaussian_splat_tpu"]


def test_no_card_means_no_result():
    # the card, where there is one, hidden from the run
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "splatbench/run.py", "--workload", "truck.view",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
def test_card_cell_runs_correct():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    line = run.run_cell("truck.view", SEED, 1.0, True, overrides=TINY)
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert "raster_fwd_roofline.view" in line["metrics"]
