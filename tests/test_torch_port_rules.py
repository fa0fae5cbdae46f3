"""Rules of the PyTorch port: it never imports JAX or the JAX package, its
entry points do not quietly fall back to the CPU, and a missing compiler
fails the kernel build loudly."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "torch_rechub_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "torch_rechub_tpu")


def imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "tools" / "rab_kernel_ablation.py"]


@pytest.mark.parametrize("path", port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_no_jax(path):
    bad = [m for m in imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_whole_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import torch_rechub_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'flax', 'optax', 'torch_rechub_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('torch_rechub_tpu_torch')]))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15  # every module of the port was imported


def test_seq_trainer_without_a_card_raises():
    from torch_rechub_tpu_torch.trainers.seq_trainer import SeqTrainer

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SeqTrainer(torch.nn.Linear(2, 2))


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    import torch.utils.cpp_extension

    from torch_rechub_tpu_torch.ops.cuda import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(torch.utils.cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()
    assert not list(tmp_path.iterdir())


def test_every_kernel_source_ships_with_the_package():
    from torch_rechub_tpu_torch.ops.cuda import _build

    for name, src in _build.SOURCES.items():
        assert src.is_file() and src.parent == PORT / "csrc", name
        assert f'extern "C" int {name}(' in src.read_text()
    assert _build.library_path("hstu_rab_fwd") == _build.library_path("hstu_rab_fwd")  # keyed by content
