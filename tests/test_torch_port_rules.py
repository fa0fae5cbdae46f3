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
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))


@pytest.mark.parametrize("path", port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_no_jax(path):
    bad = [m for m in imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


# optional packages of the pipeline, the loggers and the retrieval backends: imported where they are used, never when a
# module is imported
OPTIONAL = ("pyarrow", "tensorboardX", "wandb", "swanlab", "pandas", "annoy", "faiss", "pymilvus")


def top_level_modules(path):
    """The modules a source imports in its module body (not inside a function or class)."""
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_no_optional_package_at_import_time(path):
    bad = [m for m in top_level_modules(path) if m.split(".")[0] in OPTIONAL]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad} when it is imported"


def test_fake_evaluation_of_the_registered_op_builds_and_launches_nothing(monkeypatch):
    """``torch.export`` evaluates ``rechub::hstu_rab_fwd`` on fake tensors (fake CUDA tensors when the model lies on
    the card) and meta tensors: that takes the op's fake version, which starts no build, loads no library and
    launches nothing, also where a CUDA device is named and none exists."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from torch_rechub_tpu_torch.ops.cuda import _build
    from torch_rechub_tpu_torch.ops.cuda import hstu_rab_attention as rab

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel build or load was started")

    monkeypatch.setattr(_build, "build_all", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(subprocess, "Popen", refuse)
    before = (rab.launches, rab.launches_bf16)
    cfg = rab.BucketCfg(8)
    for dtype in (torch.float32, torch.bfloat16):
        with FakeTensorMode():
            q = torch.empty(2, 2, 16, 8, device="cuda", dtype=dtype)
            pos_w, ts_w = torch.empty(31, 2, device="cuda"), torch.empty(9, 2, device="cuda")
            ts, mask = torch.empty(2, 16, dtype=torch.int32, device="cuda"), torch.empty(2, 16, dtype=torch.bool, device="cuda")
            out = rab.hstu_attention_rab(q, q, q, pos_w, ts_w, ts, mask, 0.35, 16, cfg, torch.empty(9, dtype=torch.int32, device="cuda"))
            assert out.shape == (2, 2, 16, 8) and out.dtype == dtype and out.device.type == "cuda"
        meta = torch.empty(2, 2, 16, 8, device="meta", dtype=dtype)
        out = torch.ops.rechub.hstu_rab_fwd(meta, meta, meta, meta.new_empty(31, 2, dtype=torch.float32), meta.new_empty(9, 2, dtype=torch.float32), None, None, None, 0.35, 16, 8, "sqrt", 1.0, "minutes")
        assert out.shape == (2, 2, 16, 8) and out.device.type == "meta"
    assert (rab.launches, rab.launches_bf16) == before and not _build._loaded


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


def test_importing_serving_builds_and_loads_nothing():
    """``serving`` and every backend module import with ``subprocess`` and ``ctypes.CDLL`` refused (after torch, which
    loads its own libraries): the native HNSW
    builds and loads at its first use, and no optional package (annoy, faiss, pymilvus) is imported."""
    code = (
        "import ctypes, importlib, subprocess, sys, torch\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError(f'started while importing: {a}')\n"
        "subprocess.Popen = subprocess.run = ctypes.CDLL = refuse\n"
        "import torch_rechub_tpu_torch.serving as s\n"
        "for name in ('annoy', 'faiss', 'milvus', 'hnsw', 'bruteforce', 'retrieval', 'base'):\n"
        "    importlib.import_module('torch_rechub_tpu_torch.serving.' + name)\n"
        "import torch_rechub_tpu_torch.utils.match\n"
        "from torch_rechub_tpu_torch.serving import hnsw\n"
        "assert hnsw._lib is None\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('annoy', 'faiss', 'pymilvus'))\n"
        "assert not bad, bad\n"
        "for name in ('annoy', 'faiss', 'milvus', 'hnsw', 'bruteforce'):\n"
        "    s.builder_factory(name)\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_seq_trainer_without_a_card_raises():
    from torch_rechub_tpu_torch.trainers.seq_trainer import SeqTrainer

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SeqTrainer(torch.nn.Linear(2, 2))


def test_ctr_trainer_and_device_cached_loader_without_a_card_raise():
    import numpy as np

    from torch_rechub_tpu_torch.trainers import CTRTrainer
    from torch_rechub_tpu_torch.utils.data import DeviceCachedLoader

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CTRTrainer(torch.nn.Linear(2, 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceCachedLoader({"a": np.zeros(4, np.int32)}, np.zeros(4, np.float32), batch_size=2)
    assert DeviceCachedLoader({"a": np.zeros(4, np.int32)}, batch_size=2, device="cpu")._xs["a"].device.type == "cpu"


def test_match_trainer_and_retrieval_without_a_card_raise():
    import numpy as np

    from torch_rechub_tpu_torch.serving import brute_force_topk, builder_factory
    from torch_rechub_tpu_torch.trainers import MatchTrainer

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MatchTrainer(torch.nn.Linear(2, 2))
    emb = np.eye(3, dtype=np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        brute_force_topk(emb, emb, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        builder_factory("bruteforce").from_embeddings(emb).__enter__()
    assert brute_force_topk(emb, emb, 1, device="cpu")[0].tolist() == [[0], [1], [2]]


def test_mtl_and_rqvae_trainers_without_a_card_raise():
    from torch_rechub_tpu_torch.models.generative.rqvae import RQVAEModel
    from torch_rechub_tpu_torch.trainers import MTLTrainer, RQVAETrainer

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MTLTrainer(torch.nn.Linear(2, 2), ("classification",))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MTLTrainer(torch.nn.Linear(2, 2), ("classification", "classification"), adaptive_params={"method": "uwl"})
    model = RQVAEModel(in_dim=4, num_emb_list=(2,), e_dim=2, layers=(3,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RQVAETrainer(model)
    assert RQVAETrainer(model, device="cpu").device.type == "cpu"


def test_tiger_generate_without_a_card_raises():
    from torch_rechub_tpu_torch.models.generative import TIGERModel
    from torch_rechub_tpu_torch.models.generative.tiger import generate

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    model = TIGERModel(8, d_model=8, n_heads=2, n_enc_layers=1, n_dec_layers=1, d_ff=16, max_len=4, generator=torch.Generator().manual_seed(0))
    x = [[2, 3, 0, 0]]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(model, x, 2)
    with pytest.raises(ValueError, match="move it with model.to"):
        generate(model, x, 2, device="meta")
    assert [len(beams[0]) for beams in generate(model, x, 2, device="cpu")] == [2]


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


def test_precision_policy_is_a_port_module_without_jax():
    """``basic/precision.py`` is the port's own copy of the policy, not an import of the JAX package's."""
    path = PORT / "basic" / "precision.py"
    assert path in port_sources()
    assert not [m for m in imported_modules(path) if m.split(".")[0] in FORBIDDEN]


def test_every_kernel_input_check_takes_bf16_and_refuses_fp16():
    """Every kernel of the port has a bf16 variant: the input checks, which run before any library loads, take
    bf16 q, k, v (K3 with an f32 or a bf16 bias) and refuse fp16, a mix of dtypes, and a bf16 bias under fp32
    q.  On the CPU the wrappers keep taking the plain versions, in bf16 where the input is."""
    import importlib

    from torch_rechub_tpu_torch.ops.cuda import hstu_rab_attention as rab

    attn = importlib.import_module("torch_rechub_tpu_torch.ops.cuda.hstu_attention")
    b, h, l, d, maxl = 2, 2, 16, 8, 16
    gen = torch.Generator().manual_seed(0)
    q, k, v, g = (torch.randn(b, h, l, d, generator=gen).to(torch.bfloat16) for _ in range(4))
    cfg = rab.BucketCfg(8, "sqrt", 1.0, "minutes")
    pos_w, ts_w = torch.randn(2 * maxl - 1, h, generator=gen), torch.randn(9, h, generator=gen)
    ts = torch.sort(torch.randint(0, 10**6, (b, l), generator=gen), dim=1).values.to(torch.int32)
    mask, thr = torch.ones(b, l, dtype=torch.bool), rab.compute_bucket_thresholds(cfg)
    tables = (pos_w, ts_w, ts, mask, thr, maxl, 8)
    rab._check_kernel_inputs(q, k, v, *tables)
    rab._check_kernel_inputs(q.float(), k.float(), v.float(), *tables)
    for bad in ((q.half(), k.half(), v.half()), (q, k.float(), v), (q.float(), k.float(), v)):
        with pytest.raises(TypeError, match="all float32 or all bfloat16"):
            rab._check_kernel_inputs(*bad, *tables)
    for bias in (torch.zeros(1, h, l, l), torch.zeros(b, h, l, l, dtype=torch.bfloat16)):
        attn._check_kernel_inputs(q, k, v, bias, mask)
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        attn._check_kernel_inputs(q.half(), k.half(), v.half(), torch.zeros(1, h, l, l, dtype=torch.half), mask)
    with pytest.raises(TypeError, match="takes a bias of torch.float32,"):
        attn._check_kernel_inputs(q.float(), k.float(), v.float(), torch.zeros(1, h, l, l, dtype=torch.bfloat16), mask)
    args = (q, k, v, g, pos_w, ts_w, ts, mask, 0.25, maxl, cfg)
    dq, dpos, dts = rab.rab_backward_dq(*args)
    dk, dv = rab.rab_backward_dkv(*args)
    assert (dq.dtype, dk.dtype, dv.dtype, dpos.dtype, dts.dtype) == (torch.bfloat16,) * 3 + (torch.float32,) * 2
    out = attn.hstu_attention(q, k, v, torch.zeros(1, h, l, l), mask, 0.25, maxl)
    assert out.shape == (b, h, l, d) and out.dtype == torch.bfloat16
