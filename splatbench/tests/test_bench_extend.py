"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric by adding files and entries only: shown in a copy."""

import hashlib
import json
import shutil

from conftest import ROOT, TINY
from splatbench import run


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "splatbench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_mix_cell_and_metric_by_files_alone(tmp_path):
    shutil.copytree(ROOT / "splatbench", tmp_path / "splatbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path)
    sb = tmp_path / "splatbench"

    cfg = json.loads((sb / "configs/truck.json").read_text())
    cfg.update(name="pile", N=2000, **{k: v for k, v in TINY.items() if k != "N"})
    (sb / "configs/pile.json").write_text(json.dumps(cfg))
    mix = json.loads((sb / "traffic/view.json").read_text())
    mix.update(sample_poses=2, background=[0.0, 0.0, 0.0])
    (sb / "traffic/view_dark.json").write_text(json.dumps(mix))
    (sb / "limits/pile.view_dark.json").write_text(
        (sb / "limits/truck.view.json").read_text())
    (sb / "metrics/frames_seen.view.py").write_text(
        'UNIT, LAYER, MOVES, SOURCE = "frames", "viewer", "frames_per_s", "host_clock"\n\n\n'
        'def read(r):\n    return r.get("frames")\n')

    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "pile", "source": "a throwaway scene", "file":
                             "splatbench/configs/pile.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "pile.view_dark", "config": "pile", "traffic":
                               "view_dark", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "truck.view" in m["workloads"]:
            m["workloads"].append("pile.view_dark")
    bench["per_layer"].append({"name": "frames_seen.view", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "viewer",
                               "moves": "frames_per_s", "workloads": ["pile.view_dark"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    line = run.run_cell("pile.view_dark", 9, 0.3, True, device="cpu", root=tmp_path)
    assert line["correct"], line["checks"]
    assert line["metrics"]["frames_seen.view"]["value"] > 0
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
