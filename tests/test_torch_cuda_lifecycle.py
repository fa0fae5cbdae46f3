"""The trainer lifecycle on the card: step checkpoints of card tensors, ``prefetch_to_device``'s pinned copy
stream, and exported HSTU programs that launch K1.

These tests need a CUDA device and skip without one.  They import torch and numpy only:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_lifecycle.py

The CPU side of each module is held against the JAX package by ``tests/test_torch_checkpoint.py``,
``test_torch_export.py`` and ``test_torch_data_pipeline.py``.
"""

import numpy as np
import pytest
import torch

from torch_rechub_tpu_torch.basic.features import DenseFeature, SparseFeature
from torch_rechub_tpu_torch.data import prefetch_to_device
from torch_rechub_tpu_torch.models.generative import HSTUModel
from torch_rechub_tpu_torch.models.ranking import DeepFM
from torch_rechub_tpu_torch.ops import embedding as temb
from torch_rechub_tpu_torch.ops.cuda import hstu_rab_attention as rab
from torch_rechub_tpu_torch.trainers import CTRTrainer, SeqTrainer
from torch_rechub_tpu_torch.utils import export as texport
from torch_rechub_tpu_torch.utils.checkpoint import flat_tensors
from torch_rechub_tpu_torch.utils.data import ArrayLoader, SeqLoader

pytestmark = pytest.mark.cuda

HSTU_KW = dict(vocab_size=500, d_model=64, n_heads=2, n_layers=2, dqk=16, dv=16, max_seq_len=32, num_time_buckets=16, dropout=0.0)
# an exported program runs the model's own operations and K1: within 1e-6 of the largest eager logit
EXPORT_ATOL_REL = 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def seq_batch(n, seed=0):
    rng = np.random.default_rng(seed)
    l, v = HSTU_KW["max_seq_len"], HSTU_KW["vocab_size"]
    toks = rng.integers(1, v, (n, l)).astype(np.int32)
    toks[::2, : l // 4] = 0
    tds = np.sort(rng.integers(0, 10**6, (n, l)), axis=1).astype(np.int32)
    return toks, np.tile(np.arange(l, dtype=np.int32), (n, 1)), rng.integers(1, v, n).astype(np.int32), tds


def assert_states_equal(a, b, device):
    fa, fb = dict(flat_tensors(a)), dict(flat_tensors(b))
    assert fa.keys() == fb.keys()
    for k, v in fa.items():
        if isinstance(v, torch.Tensor):
            assert v.device == fb[k].device and torch.equal(v, fb[k]), k
        else:
            assert v == fb[k], k
    assert any(isinstance(v, torch.Tensor) and v.device.type == device.type for v in fa.values())


def test_hstu_checkpoint_round_trip_of_card_tensors(card, tmp_path):
    data = seq_batch(16, seed=1)

    def build():
        return SeqTrainer(HSTUModel(**HSTU_KW, generator=torch.Generator().manual_seed(0), device=card))

    trainer = build()
    ckpt = trainer.enable_step_checkpointing(str(tmp_path), every_n_steps=2)
    trainer.train_one_epoch(SeqLoader(*data, batch_size=8), log_interval=0)
    trainer.maybe_step_checkpoint()
    assert ckpt.latest_step() == 2
    fresh = build()
    fresh.enable_step_checkpointing(str(tmp_path), every_n_steps=2)
    assert fresh.maybe_resume() == 2
    assert_states_equal(fresh.train_state(), trainer.train_state(), card)


def test_sparse_ctr_checkpoint_round_trip_and_steps_on_the_card(card, tmp_path):
    old = temb.set_fused_default(True)
    try:
        sparse = tuple(SparseFeature(f"C{i}", 1000, 8) for i in range(4))
        rng = np.random.default_rng(2)
        x = {f"C{i}": rng.integers(0, 1000, 7 * 64).astype(np.int32) for i in range(4)}
        x["I0"] = rng.normal(size=7 * 64).astype(np.float32)
        y = rng.integers(0, 2, 7 * 64).astype(np.float32)

        def build():
            model = DeepFM((DenseFeature("I0"),) + sparse, sparse, {"dims": (16,), "dropout": 0.0}, generator=torch.Generator().manual_seed(3), device=card)
            return CTRTrainer(model, sparse_embedding="adagrad")

        trainer = build()
        ckpt = trainer.enable_step_checkpointing(str(tmp_path), every_n_steps=3, max_to_keep=1)
        trainer.train_one_epoch(ArrayLoader(x, y, batch_size=64), log_interval=0)  # the prefetching loop
        assert trainer.step == 7 and ckpt.steps() == [6]
        fresh = build()
        fresh.enable_step_checkpointing(str(tmp_path), every_n_steps=3)
        assert fresh.maybe_resume() == 6 and fresh.step == 6
        assert set(fresh.sparse_accums) == set(trainer.sparse_accums) and all(a.is_cuda for a in fresh.sparse_accums.values())
    finally:
        temb.set_fused_default(old)


def test_prefetch_to_device_values_and_order_from_pinned_memory(card):
    """Each batch's values, in order, while the consumer's stream is busy (a spin wait) and writes into the batch:
    a copy stream without the event wait, or memory reused without ``record_stream``, shows as wrong values."""
    rng = np.random.default_rng(4)
    host = [({"a": rng.normal(size=(256, 1024)).astype(np.float32), "i": np.full(3, k, np.int64)}, rng.integers(0, 9, 4096).astype(np.int32)) for k in range(24)]
    seen = []
    for k, (x, ids) in enumerate(prefetch_to_device(iter(host), size=3)):
        assert x["a"].is_cuda and ids.is_cuda and x["a"].dtype == torch.float32 and ids.dtype == torch.int32
        torch.cuda._sleep(1_000_000)
        x["a"].mul_(2.0)
        seen.append((int(x["i"][0]), torch.equal(x["a"].cpu(), torch.from_numpy(host[k][0]["a"] * 2.0)), torch.equal(ids.cpu(), torch.from_numpy(host[k][1]))))
    assert [s[0] for s in seen] == list(range(24)) and all(s[1] and s[2] for s in seen)


def hstu_and_request(card, seed=5):
    model = HSTUModel(**HSTU_KW, generator=torch.Generator().manual_seed(seed), device=card).eval()
    toks, _, _, tds = seq_batch(4, seed=seed)
    return model, (toks, tds)


def test_exported_hstu_launches_k1_and_matches_eager(card, tmp_path):
    model, request = hstu_and_request(card)
    path = texport.TorchExporter(model).export(str(tmp_path / "hstu"), request)
    run, _ = texport.load_exported(path)
    rab.launches = 0
    out = run(request)
    torch.cuda.synchronize()
    assert rab.launches == HSTU_KW["n_layers"] and out.is_cuda
    with torch.no_grad():
        eager = model(*(torch.as_tensor(a, device=card) for a in request))
    assert float((out - eager).abs().max()) <= EXPORT_ATOL_REL * float(eager.abs().max())


@pytest.mark.parametrize("quant_mode", ["int8", "fp16"])
def test_quantized_export_runs_on_the_card(card, tmp_path, quant_mode):
    """The quantized program launches K1, its weights are int8 / fp16, and its logits lie within the first-order
    bound of its weights' error: each of the K quantized tensors on the path moves by at most ``quantization_error``
    of its largest value, so the logits by about K times that of the largest logit."""
    model, request = hstu_and_request(card, seed=6)
    exporter = texport.TorchExporter(model)
    run, state = texport.load_exported(exporter.export_quantized(str(tmp_path / quant_mode), request, quant_mode=quant_mode))
    rab.launches = 0
    out = run(request)
    torch.cuda.synchronize()
    assert rab.launches == HSTU_KW["n_layers"]
    want = torch.int8 if quant_mode == "int8" else torch.float16
    assert any(t.dtype == want and t.is_cuda for t in state.values())
    params = dict(model.named_parameters())
    rows = texport.linear_weight_names(model)
    err = texport.quantization_error(params, quant_mode, rows)
    k = sum(p.ndim == 2 for p in params.values()) if quant_mode == "int8" else len(params)
    with torch.no_grad():
        eager = model(*(torch.as_tensor(a, device=card) for a in request))
    assert 0 < float((out - eager).abs().max()) <= k * err * float(eager.abs().max())
