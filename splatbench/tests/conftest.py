"""The benchmark's own tests: `pytest splatbench/tests` from the checkout's
root, on the CPU. A test marked `card` needs an NVIDIA card and skips
without one (it decides inside the test)."""

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the tests run several workers at once: one thread each
torch.set_num_threads(1)


def _tiny_cameras():
    cams = json.loads((ROOT / "splatbench/configs/truck.json").read_text())["cameras"]
    return {"train": {**cams["train"], "count": 6}, "orbit": {**cams["orbit"], "count": 12}}


# a cell cut to a size the CPU runs in seconds (the harness's tests only)
TINY = {"N": 3000, "width": 96, "height": 64, "cameras": _tiny_cameras()}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")
