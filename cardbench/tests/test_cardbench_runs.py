"""Whole runs of the harness on the CPU at tiny sizes: sound runs come out correct, and each fault
planted underneath the timed path makes ``correct`` come out false.

The look for a card is skipped (``device`` is given); everything after it
runs as on the card: set-up and first steps, the window, the reference,
the comparison against the cell's own limits.
"""

import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from cardbench import faults, harness
from cardbench.tests.common import TINY

ROOT = Path(__file__).resolve().parents[2]


def test_every_cell_has_a_tiny_size():
    assert set(TINY) == {w["name"] for w in harness.load_json(ROOT / "BENCHMARK.json")["workloads"]}


def run(cell, fault=None, trace=0, seed=2**31 + 4242):
    args = SimpleNamespace(workload=cell, seed=seed, seconds=0.2, trace=trace)
    return harness.run(args, time.perf_counter(), device=torch.device("cpu"), overrides=TINY[cell], fault=fault)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_sound_run_is_correct(cell):
    out = run(cell)
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks" and all(c["value"] <= c["limit"] for c in out["checks"].values())
    e2e = {m["name"] for m in harness.load_json(ROOT / "BENCHMARK.json")["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == e2e and all(v["value"] > 0 for v in out["metrics"].values())


PLANTED = {"hstu-books.train": faults.TRAIN, "deepfm-criteo.train": faults.TRAIN, "hstu-books.serve": faults.SERVE}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in PLANTED.items() for f in fs])
def test_a_planted_fault_is_not_correct(cell, fault):
    out = run(cell, PLANTED[cell][fault])
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_a_traced_run_reports_its_layer_metrics():
    out = run("hstu-books.serve", trace=1)
    assert out["correct"] is True and "step_mfu.serve" in out["metrics"]  # the CPU's trace has no device events
    assert out["device"]["window_s"] > 0 and set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_result_line_is_json_with_non_finite_checks():
    line = harness.finite({"checks": {"answer_gap": {"value": float("inf"), "limit": 1e-4}}, "x": [float("nan")]})
    assert json.loads(json.dumps(line)) == {"checks": {"answer_gap": {"value": "inf", "limit": 1e-4}}, "x": ["nan"]}


def test_without_a_card_the_command_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would take it")
    out = subprocess.run([sys.executable, str(ROOT / "cardbench" / "run.py"), "--workload", "hstu-books.train", "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT / "build")})
    assert out.returncode != 0 and out.stdout.strip() == "" and "no CUDA device" in out.stderr


def test_a_run_that_imported_jax_prints_no_result(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jaxlib", sys.modules["json"])
    with pytest.raises(SystemExit) as stop:
        harness.report({"checks": {}, "correct": True})
    out = capsys.readouterr()
    assert stop.value.code == 3 and out.out == "" and "jaxlib" in out.err
