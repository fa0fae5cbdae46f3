"""The port's tutorials (``tutorials_torch/``): the generator writes exactly the
committed notebooks, unexecuted, and every code cell of every notebook runs on
the CPU (``TORCH_RECHUB_DEVICE=cpu``), from ``tutorials_torch/`` as a notebook
would.  That no cell imports JAX, the JAX package, ``benchmarks`` or
``examples`` is ``tests/test_torch_port_rules.py``'s."""

import importlib.util
import json
import os
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
TUTORIALS = ROOT / "tutorials_torch"
NAMES = ("00_QuickStart_CTR_DeepFM.ipynb", "01_Ranking_DIN.ipynb", "02_Matching_DSSM.ipynb", "03_MultiTask_MMOE.ipynb",
         "04_Experiment_Tracking.ipynb", "05_Model_Export_and_Serving.ipynb", "06_Scaling_and_Precision.ipynb")


def code_cells(name):
    with open(TUTORIALS / name) as f:
        return ["".join(c["source"]) for c in json.load(f)["cells"] if c["cell_type"] == "code"]


def generator():
    spec = importlib.util.spec_from_file_location("make_tutorials_torch", TUTORIALS / "make_tutorials.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_seven_notebooks_are_the_jax_tutorials_names():
    assert sorted(p.name for p in TUTORIALS.glob("*.ipynb")) == list(NAMES)
    assert sorted(p.name for p in (ROOT / "tutorials").glob("*.ipynb")) == list(NAMES)


def test_generator_writes_the_committed_notebooks():
    import nbformat

    made = generator().notebooks()
    assert sorted(made) == list(NAMES)
    for name, notebook in made.items():
        with open(TUTORIALS / name) as f:
            assert json.loads(nbformat.writes(notebook)) == json.load(f), f"{name}: run python tutorials_torch/make_tutorials.py"


@pytest.mark.parametrize("name", NAMES)
def test_notebook_is_committed_unexecuted(name):
    with open(TUTORIALS / name) as f:
        cells = json.load(f)["cells"]
    assert all(not c.get("outputs") and c.get("execution_count") is None for c in cells if c["cell_type"] == "code")


@pytest.mark.parametrize("name", NAMES)
def test_notebook_runs_on_the_cpu(name, monkeypatch):
    """Every code cell in order, in one namespace, from ``tutorials_torch/`` with ``TORCH_RECHUB_DEVICE=cpu``; the
    setup cell's ``DEVICE`` is the CPU and the notebook's outputs land in its own temporary directory."""
    monkeypatch.setenv("TORCH_RECHUB_DEVICE", "cpu")
    monkeypatch.chdir(TUTORIALS)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    ns = {}
    try:
        for i, src in enumerate(code_cells(name)):
            try:
                exec(compile(src, f"{name}::cell{i}", "exec"), ns)
            except Exception as e:  # pragma: no cover - failure reporting
                pytest.fail(f"{name} cell {i} failed: {type(e).__name__}: {e}\n--- cell source ---\n{src}")
    finally:
        torch.set_num_threads(threads)
    assert ns["DEVICE"] == torch.device("cpu")
    assert os.path.basename(ns["OUT"]).startswith(f"rechub_torch_tut{name[:2]}_")
