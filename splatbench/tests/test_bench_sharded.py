"""Whole runs of the four-rank cell `rubble40m.train4` at a tiny size on the
CPU (gloo ranks, the port's plain CPU path): a sound run comes out correct,
the control and every planted fault come out not correct, and a run that
loses a rank, or finds too few cards, ends with exit code 2."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, TINY
from splatbench import control_sharded, run

CELL = "rubble40m.train4"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2**31 + 12345


def _tiny(fault=None, trace=False):
    return run.run_cell(CELL, SEED, 0.3, trace, device="cpu", overrides=TINY, fault=fault)


def test_sound_run_is_correct():
    line = _tiny(trace=True)
    assert line["correct"], line["checks"]
    assert line["device"]["count"] == 4
    assert "band.max_records_share.train4" in line["metrics"]
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("fault", ["half_batch", "state_unchanged", "stats_lost", "no_reduce"])
def test_planted_fault_is_not_correct(fault):
    assert not _tiny(fault)["correct"]


def test_control_is_not_correct():
    _, _, _, limits = run.resolve(ROOT, BENCH, CELL)
    numbers = control_sharded.control_numbers(CELL, SEED, "cpu", overrides=TINY)
    assert any(numbers[k] > limits[k] for k in limits), numbers


def test_lost_rank_ends_the_run_with_exit_2():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from splatbench import run\n"
        "if __name__ == '__main__':\n"
        "    run.run_cell(%r, 3, 0.2, False, device='cpu', overrides=%r, fault='rank_lost')\n"
        % (str(ROOT), CELL, TINY))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 2, out.stderr[-2000:]
    assert out.stdout.strip() == ""


def test_too_few_cards_means_exit_2():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "splatbench/run.py", "--workload", CELL,
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 2 and out.stdout.strip() == ""
