"""BENCHMARK.json against the contract's shape, and every name it gives
found as a file."""

import json
import re

import pytest

from conftest import ROOT
from splatbench import run

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "splatbench/run.py"]
    assert BENCH["paths"] == ["splatbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(group):
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
    }[group]
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))
    for e in BENCH[group]:
        assert set(e) <= allowed, e
        assert NAME.match(e["name"]), e["name"]
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        if group == "workloads":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"]) and e["chips"] in (1, 4)
        if group == "configs":
            assert all(NAME.match(k) for k in e["reduced"]) and len(e["reduced"]) <= 16


def test_metrics_sound():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for cell in m.get("workloads", []):
            assert cell in CELLS
            assert any(e["name"] == m["moves"] for e in run.end_to_end(BENCH, cell))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found(cell):
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    _, cfg, traffic, limits = run.resolve(ROOT, BENCH, cell)
    assert cfg["name"] == w["config"]
    assert (ROOT / "splatbench" / "runners" / f"{traffic['runner']}.py").exists()
    assert limits
    e2e = [m["name"] for m in run.end_to_end(BENCH, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = run.per_layer(BENCH, cell)
    assert layer
    for m in layer:
        mod = run.reader(ROOT, m["name"])
        assert (mod.UNIT, mod.LAYER, mod.MOVES, mod.SOURCE) == (
            m["unit"], m["layer"], m["moves"], m["source"])


def test_every_config_has_a_cell_and_a_file_of_its_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("splatbench/") and (ROOT / c["file"]).exists()
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and len(c["source"]) <= 200


def test_four_chip_cells_at_most_a_quarter():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
