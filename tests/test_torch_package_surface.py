"""The port's package surface against the JAX package's: the trainers take the
same parameters in the same order (plus a trailing ``device``), a device mesh
is taken and anything else refused by name, every name of the JAX package's ``__all__`` lists imports
from its counterpart in the port, and importing the port builds nothing."""

import importlib
import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import torch_rechub_tpu.trainers as jax_trainers
import torch_rechub_tpu_torch.trainers as port_trainers

ROOT = Path(__file__).resolve().parents[1]
TRAINERS = ("CTRTrainer", "MatchTrainer", "MTLTrainer", "RQVAETrainer", "SeqTrainer")
# the JAX package's modules that declare ``__all__``, by their path below the package
SURFACES = ("", ".basic", ".data", ".ops", ".parallel", ".utils")


def parameters(cls):
    return list(inspect.signature(cls.__init__).parameters)


@pytest.mark.parametrize("name", TRAINERS)
def test_trainer_takes_the_jax_parameters_then_device(name):
    assert parameters(getattr(port_trainers, name)) == parameters(getattr(jax_trainers, name)) + ["device"]


@pytest.mark.parametrize("name", TRAINERS)
def test_trainer_refuses_a_mesh_naming_the_roadmap_item(name):
    """Every trainer takes a device mesh (tests/test_torch_mesh_train.py) and refuses anything that is not one,
    naming the type it takes."""
    args = (torch.nn.Linear(2, 2), ["classification"]) if name == "MTLTrainer" else (torch.nn.Linear(2, 2),)
    with pytest.raises(TypeError, match="DeviceMesh"):
        getattr(port_trainers, name)(*args, mesh=object(), device="cpu")


def surface_names():
    return [(sub, name) for sub in SURFACES for name in importlib.import_module("torch_rechub_tpu" + sub).__all__]


@pytest.mark.parametrize("sub,name", surface_names(), ids=lambda x: x or "package")
def test_every_jax_all_name_imports_from_the_port(sub, name):
    port = importlib.import_module("torch_rechub_tpu_torch" + sub)
    assert name in port.__all__
    obj = getattr(port, name)
    if inspect.ismodule(obj):
        assert obj.__name__.startswith("torch_rechub_tpu_torch.") and obj.__name__.endswith("." + name)
    elif name != "__version__":
        assert obj.__module__.startswith("torch_rechub_tpu_torch")


def test_the_port_and_jax_all_lists_agree():
    for sub in SURFACES:
        assert importlib.import_module("torch_rechub_tpu_torch" + sub).__all__ == importlib.import_module("torch_rechub_tpu" + sub).__all__, sub


def test_importing_the_port_starts_no_build():
    """The package and every subpackage import with ``subprocess.Popen`` refused: the kernels build at their first
    launch (``ops/cuda/_build.py``), never at import, and nothing is loaded."""
    code = (
        "import importlib, pkgutil, subprocess\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError(f'a process was started while importing: {a}')\n"
        "subprocess.Popen = refuse\n"
        "import torch_rechub_tpu_torch as p\n"
        "from torch_rechub_tpu_torch import SparseFeature\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from torch_rechub_tpu_torch.ops.cuda import _build\n"
        "assert not _build._loaded and not _build.build_log, (_build._loaded, _build.build_log)\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
