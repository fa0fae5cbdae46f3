"""The port's package surface against the JAX package's: the trainers take the
same parameters in the same order (plus a trailing ``device``), every public
function and class that the JAX package's ``__all__`` lists name takes JAX's
keywords in JAX's positions, a device mesh is taken and anything else refused
by name, every name of the JAX package's ``__all__`` lists imports from its
counterpart in the port, and importing the port builds nothing."""

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


LOADERS = ("ArrayLoader", "DeviceCachedLoader", "DataGenerator", "SequenceDataGenerator", "MatchDataGenerator")


@pytest.mark.parametrize("name", LOADERS)
def test_data_loader_takes_the_jax_parameters_then_device(name):
    """The loaders take the JAX package's parameters in its order, plus a trailing ``device`` where the port's loader
    places data on one (``DeviceCachedLoader``, which takes JAX's ``mesh`` too)."""
    import torch_rechub_tpu.utils.data as jax_data
    import torch_rechub_tpu_torch.utils.data as port_data

    port, ref = parameters(getattr(port_data, name)), parameters(getattr(jax_data, name))
    assert port == ref + ["device"] * (name == "DeviceCachedLoader")


def test_device_cached_loader_refuses_a_mesh_naming_the_type():
    import numpy as np

    from torch_rechub_tpu_torch.utils.data import DeviceCachedLoader

    with pytest.raises(TypeError, match="DeviceMesh"):
        DeviceCachedLoader({"a": np.zeros(4, np.int32)}, batch_size=2, mesh=object(), device="cpu")


# every module of the JAX package with an ``__all__`` list that has a counterpart at the same path in the port
# (``ops.pallas`` holds the TPU kernels; the port's are ``ops.cuda``)
ALL_LISTS = SURFACES + (".models", ".models.generative", ".models.matching", ".models.multi_task", ".models.ranking", ".serving", ".trainers")
# public names outside every ``__all__`` that JAX callers pass keywords to
OUTSIDE_ALL = (("utils.checkpoint", "TrainCheckpointer"), ("models.matching.base", "l2_normalize"))
FLAX_FIELDS = ["parent", "name"]  # the trailing dataclass fields of every flax Module, not a model's keywords
# the torch idioms, the only parameters the port may add: trailing, after all of JAX's
TORCH_TRAILING = {
    "generator": "the torch.Generator that draws a module's weights and dropout (flax takes rngs at init / apply)",
    "device": "where a module, loader or result is placed (JAX places by sharding)",
    "rng": "the numpy Generator of the data helpers' shuffles and samples (JAX's use numpy's global state)",
    "use_fused_kernel": "HSTUModel's switch between the card's kernels and the plain version (one fused op in JAX)",
}
# the input widths that a torch module needs when it is made, where flax infers them at its first call: the only
# parameters the port may add in front of JAX's
TORCH_WIDTHS = {"in_features", "d", "embed_dim"}


def public_callables():
    """``(label, jax object, port object)`` for every function and class named by an ``__all__`` list, or public
    in a module that one names, and the :data:`OUTSIDE_ALL` names."""
    out = []
    for sub in ALL_LISTS:
        jmod, pmod = importlib.import_module("torch_rechub_tpu" + sub), importlib.import_module("torch_rechub_tpu_torch" + sub)
        for name in jmod.__all__:
            obj = getattr(jmod, name)
            if inspect.ismodule(obj):
                out += [(f"{obj.__name__}.{n}", o, getattr(getattr(pmod, name), n, None)) for n, o in vars(obj).items()
                        if not n.startswith("_") and (inspect.isfunction(o) or inspect.isclass(o)) and o.__module__ == obj.__name__]
            elif inspect.isfunction(obj) or inspect.isclass(obj):
                out.append((f"torch_rechub_tpu{sub}.{name}", obj, getattr(pmod, name)))
    for mod, name in OUTSIDE_ALL:
        out.append((f"torch_rechub_tpu.{mod}.{name}", getattr(importlib.import_module("torch_rechub_tpu." + mod), name),
                    getattr(importlib.import_module("torch_rechub_tpu_torch." + mod), name, None)))
    return sorted({label: (label, j, p) for label, j, p in out}.values(), key=lambda x: x[0])


def signature(obj):
    return inspect.signature(obj.__init__ if inspect.isclass(obj) else obj)


def keywords(obj):
    return [p for p in signature(obj).parameters if p != "self"]


@pytest.mark.parametrize("label,jax_obj,port_obj", public_callables(), ids=lambda x: x if isinstance(x, str) else "")
def test_public_callable_takes_the_jax_keywords_in_their_positions(label, jax_obj, port_obj):
    """JAX's parameters, by name and in order, come first in the port's (after the input widths a torch module
    takes up front, :data:`TORCH_WIDTHS`); all that follows them is a torch idiom of :data:`TORCH_TRAILING`, with a
    default.  So a JAX caller's positional and keyword arguments bind as they do in JAX
    (``TrainCheckpointer(d, 3, False)``, ``l2_normalize(x, axis=-1)``, ``generate_seq_feature(df, "user_id", ...)``)."""
    assert port_obj is not None, f"{label} has no counterpart in the port"
    ref, port = keywords(jax_obj), keywords(port_obj)
    if ref[-2:] == FLAX_FIELDS:
        ref = ref[:-2]
    while port and port[0] in TORCH_WIDTHS and port[0] not in ref:
        port = port[1:]
    assert port[:len(ref)] == ref, f"{label}: JAX takes {ref}, the port {port}"
    assert all(p in TORCH_TRAILING for p in port[len(ref):]), f"{label}: the port adds {port[len(ref):]} after JAX's {ref}"
    params = signature(port_obj).parameters
    required = [p for p in port[len(ref):] if params[p].default is inspect.Parameter.empty and params[p].kind not in (params[p].VAR_POSITIONAL, params[p].VAR_KEYWORD)]
    assert not required, f"{label}: a JAX call binds none of {required}, which the port requires"


def test_jax_positional_calls_run_in_the_port(tmp_path):
    from torch_rechub_tpu_torch.models.matching.base import l2_normalize
    from torch_rechub_tpu_torch.utils.checkpoint import TrainCheckpointer

    ckpt = TrainCheckpointer(str(tmp_path), 3, False)
    ckpt.save(1, {"w": torch.ones(2)})
    assert ckpt.restore({"w": torch.zeros(2)})[1] == 1 and ckpt.max_to_keep == 3
    x = torch.tensor([[3.0, 4.0], [0.0, 0.0]])
    torch.testing.assert_close(l2_normalize(x, axis=-1), torch.tensor([[0.6, 0.8], [0.0, 0.0]]))
    torch.testing.assert_close(l2_normalize(x, 0, 1e-12), x / torch.tensor([3.0, 4.0]))


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
