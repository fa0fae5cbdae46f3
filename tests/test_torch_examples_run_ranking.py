"""Every script of ``examples_torch/`` end to end on the CPU (``--device cpu``), as ``tests/test_examples_smoke.py``
runs the JAX package's production recipe: each script in this process through its argv entry
(``runpy.run_path(..., run_name="__main__")``) at tiny flags, its printed result line asserted.  This file holds
``ranking/`` and ``serving/``; ``test_torch_examples_run_generative.py`` the rest."""

import math
import os
import re
import runpy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples_torch"
NUMBER = r"(-?\d+(?:\.\d+)?(?:e[-+]?\d+)?|nan)"


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def run_script(rel, argv, tmp_path, monkeypatch, capsys):
    """Run ``examples_torch/<rel>`` as ``__main__`` with ``argv`` (plus ``--device cpu`` and ``--save_dir`` in
    ``tmp_path`` where the script takes one); returns its standard output.  ``sys.argv`` and ``sys.path`` are
    restored afterwards (the presets insert their flags, every script its repo root)."""
    path = EXAMPLES / rel
    extra = ["--device", "cpu"] + (["--save_dir", str(tmp_path / "saved")] if "--save_dir" in path.read_text() else [])
    monkeypatch.setattr(sys, "argv", [str(path)] + list(argv) + extra)
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.chdir(tmp_path)
    runpy.run_path(str(path), run_name="__main__")
    return capsys.readouterr().out


def numbers(line):
    return [float(v) for v in re.findall(NUMBER, line)]


def last_match(pattern, out):
    lines = [line for line in out.splitlines() if re.search(pattern, line)]
    assert lines, f"no line matches {pattern!r} in:\n{out[-3000:]}"
    return lines[-1]


RANKING = {
    "ranking/run_criteo.py": (["--epoch", "1", "--batch_size", "512"], r"^test auc: " + NUMBER + "$"),
    "ranking/run_avazu.py": (["--epoch", "1", "--batch_size", "512"], r"^test auc: " + NUMBER + "$"),
    "ranking/run_avazu.py --model_name deepffm": (["--epoch", "1", "--batch_size", "512", "--model_name", "deepffm"], r"^test auc: " + NUMBER + "$"),
    "ranking/run_ali_ccp_ctr_ranking.py": (["--epoch", "1", "--batch_size", "512"], r"^test auc: " + NUMBER + "$"),
    "ranking/run_amazon_electronics.py": (["--epoch", "1", "--batch_size", "512"], r"^test AUC: " + NUMBER + "$"),
    "ranking/run_amazon_electronics.py --model_name bst": (["--epoch", "1", "--batch_size", "512", "--model_name", "bst"], r"^test AUC: " + NUMBER + "$"),
    "ranking/run_dien.py": (["--epoch", "1", "--batch_size", "512"], r"^test AUC: " + NUMBER + "$"),
    "ranking/run_multi_task.py": (["--epoch", "1", "--batch_size", "512"], r"^final scores: \["),
    "ranking/run_multi_task.py --model_name esmm": (["--epoch", "1", "--batch_size", "512", "--model_name", "esmm"], r"^final scores: \["),
    "ranking/run_census.py": (["--epoch", "1", "--batch_size", "512", "--model_name", "ple"], r"^final scores: \["),
    "ranking/run_aliexpress.py": (["--epoch", "1", "--batch_size", "512", "--model_name", "aitm"], r"^final scores: \["),
    "ranking/run_ali_ccp_multi_task.py": (["--epoch", "1", "--batch_size", "512", "--adaptive", "uwl", "--model_name", "sharedbottom"], r"^final scores: \["),
    "ranking/run_gradnorm.py": (["--epoch", "1", "--batch_size", "512"], r"^final scores: \["),
    "ranking/run_metabalance.py": (["--epoch", "1", "--batch_size", "512"], r"^final scores: \["),
    "ranking/run_criteo_production.py": (["--scale", "0.001", "--n-examples", "8192", "--batch-size", "1024"], r"^train AUC \(bucketed, device-side\): " + NUMBER + "$"),
    "serving/run_quantize_export.py": (["--epoch", "1"], r"^bruteforce: build " + NUMBER + " ms, " + NUMBER + r" ms/query, self-top1 hit " + NUMBER + "$"),
    "serving/run_quantize_export.py --backend hnsw --mode fp16": (["--epoch", "1", "--backend", "hnsw", "--mode", "fp16"], r"^hnsw: build .* self-top1 hit " + NUMBER + "$"),
}


MTL_DATA = {"run_multi_task.py": "build_census_multitask_dataset", "run_census.py": "build_census_multitask_dataset", "run_aliexpress.py": "build_aliexpress_multitask_dataset",
            "run_ali_ccp_multi_task.py": "build_aliccp_multitask_dataset", "run_gradnorm.py": "build_aliccp_multitask_dataset", "run_metabalance.py": "build_aliccp_multitask_dataset"}


def one_class_tasks(case):
    """The tasks of a multi-task case whose test labels hold one class, so that its AUC is undefined (nan): the
    committed AliExpress sample's 24 test rows hold no positive, and ESMM's third task (cvr x ctr) none on census."""
    script = case.split()[0].rsplit("/", 1)[-1]
    if script not in MTL_DATA:
        return set()
    from examples_torch import datasets
    from examples_torch.ranking.mtl_common import esmm_labels

    y = getattr(datasets, MTL_DATA[script])().y_test
    if "esmm" in case:
        y = esmm_labels(y)
    return {i for i in range(y.shape[1]) if len(set(y[:, i].tolist())) < 2}


@pytest.mark.parametrize("case", sorted(RANKING))
def test_ranking_and_serving_scripts_run_on_the_cpu(case, tmp_path, monkeypatch, capsys):
    argv, pattern = RANKING[case]
    out = run_script(case.split()[0], argv, tmp_path, monkeypatch, capsys)
    line = last_match(pattern, out)
    values = numbers(line.split(":", 1)[1])
    one_class = one_class_tasks(case)
    assert values and all(math.isfinite(v) != (i in one_class) for i, v in enumerate(values)), (line, one_class)
    if case.startswith("serving/"):
        assert re.search(r"^exported item tower -> fp32 .* KiB \.pt2", out, re.M) and "max relative reconstruction error" in out
    if case.startswith("ranking/run_criteo_production"):
        assert re.search(r"^epoch 0: loss " + NUMBER + "  ", out, re.M)


def test_every_ranking_and_serving_script_has_a_case():
    scripts = {str(p.relative_to(EXAMPLES)) for d in ("ranking", "serving") for p in (EXAMPLES / d).glob("*.py")}
    ran = {case.split()[0] for case in RANKING}
    assert scripts - ran == {"ranking/mtl_common.py"}, scripts - ran  # mtl_common runs under the five multi-task scripts
    assert ran <= scripts
