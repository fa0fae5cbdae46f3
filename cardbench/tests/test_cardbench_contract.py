"""``BENCHMARK.json`` reads as the benchmark's contract says, and every file a cell names is there."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def cells_reporting(metric):
    return set(metric.get("workloads", CELLS))


def test_top_level_and_paths():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "cardbench/run.py"] and BENCH["paths"] == ["cardbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_the_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configurations():
    assert 1 <= len(BENCH["configs"]) <= 24
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert text_ok(c["source"]) and text_ok(c["why"]) and c["file"].startswith("cardbench/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def test_cells():
    assert 1 <= len(CELLS) <= 24 and len(CELLS) == len(BENCH["workloads"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(CELLS)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4) and text_ok(w["why"])
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert (ROOT / "cardbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "cardbench" / "limits" / f"{w['name']}.json").is_file()


def test_metrics_names_units_sources():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(CELLS)
    assert E2E["setup_s"]["unit"] == "s" and "workloads" not in E2E["setup_s"] and E2E["setup_s"]["bound"] <= 0.25


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_layer_metric_moves_a_metric_its_cells_report(metric):
    assert set(metric) == {"name", "unit", "better", "source", "layer", "moves", "workloads"} and metric["workloads"]
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock") and text_ok(metric["layer"])
    assert metric["moves"] in E2E and cells_reporting(metric) <= cells_reporting(E2E[metric["moves"]])
    assert (ROOT / "cardbench" / "layer_metrics" / f"{metric['name']}.py").is_file()
    if metric["name"].endswith("_roofline") or "_roofline." in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for name in CELLS:
        e2e = [m for m in BENCH["end_to_end"] if name in cells_reporting(m)]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(name in cells_reporting(m) for m in BENCH["per_layer"])


def test_one_layer_name_per_layer():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())
