"""The port's CUDA kernels on the card, against their plain PyTorch versions.

These tests need a CUDA device and skip without one (the kernels have no CPU
mode).  They import torch and numpy only, so they also run where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: ``tests/conftest.py`` sets up JAX.)
"""

import math

import numpy as np
import pytest
import torch

from torch_rechub_tpu_torch.models.generative import HSTUModel
from torch_rechub_tpu_torch.ops.cuda import hstu_rab_attention as rab

pytestmark = pytest.mark.cuda

# fp32 FMAs summed in another order than cuBLAS's: 1e-4 relative, 1e-5 absolute
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rab_inputs(device, b=2, h=3, l=256, maxl=256, d=32, dv=32, nb=16, seed=0, times="sorted", mask="suffix"):
    rng = np.random.default_rng(seed)
    t = {
        "q": rng.normal(size=(b, h, l, d)) * 0.3,
        "k": rng.normal(size=(b, h, l, d)) * 0.3,
        "v": rng.normal(size=(b, h, l, dv)) * 0.3,
        "pos_w": rng.normal(size=(2 * maxl - 1, h)) * 0.1,
        "ts_w": rng.normal(size=(nb + 1, h)) * 0.1,
    }
    t = {k: torch.from_numpy(a.astype(np.float32)).to(device) for k, a in t.items()}
    ts = None
    if times == "sorted":
        ts = np.sort(rng.integers(0, 3_000_000, (b, l)), axis=1)
    elif times == "shuffled":
        ts = rng.integers(0, 3_000_000, (b, l))
    elif times == "wrapping":  # both ends of int32: the int32 differences wrap to small values
        near = rng.integers(0, 20_000, (b, l))
        ts = np.where(rng.uniform(size=(b, l)) < 0.5, 2**31 - 1 - near, -(2**31) + near)
    t["timestamps"] = None if ts is None else torch.from_numpy(ts.astype(np.int32)).to(device)
    m = None
    if mask == "suffix":
        m = np.arange(l)[None, :] < l - 17
        m = np.broadcast_to(m, (b, l)).copy()
    elif mask == "scattered":
        m = rng.uniform(size=(b, l)) > 0.3
    elif mask == "empty_row":
        m = np.ones((b, l), bool)
        m[0] = False
    t["padding_mask"] = None if m is None else torch.from_numpy(m).to(device)
    return t, dict(alpha=1.0 / math.sqrt(d), max_seq_len=maxl, cfg=rab.BucketCfg(nb))


CASES = {
    "sorted_suffix": dict(),
    "shuffled_scattered": dict(times="shuffled", mask="scattered"),
    "empty_row": dict(times="shuffled", mask="empty_row"),
    "wrapping_times": dict(times="wrapping", mask="scattered"),
    "no_time_no_mask": dict(times=None, mask=None),
    "ragged_200": dict(l=200),
    "ragged_77_d64": dict(l=77, d=64, dv=64),
    "dv16_dqk8": dict(d=8, dv=16),
    "dv8_dqk8": dict(d=8, dv=8),
    "dv20_dqk12_ragged": dict(l=131, d=12, dv=20),
    "dv128": dict(l=128, maxl=128, d=64, dv=128),
    "long_1024": dict(b=1, l=1024, maxl=1024, nb=128),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain(card, case):
    t, kw = rab_inputs(card, **CASES[case])
    before = rab.launches
    out = rab.hstu_attention_rab(t["q"], t["k"], t["v"], t["pos_w"], t["ts_w"], t["timestamps"], t["padding_mask"], kw["alpha"], kw["max_seq_len"], kw["cfg"])
    torch.cuda.synchronize()
    assert rab.launches == before + 1
    ref = rab.dense_forward(t["q"], t["k"], t["v"], t["pos_w"], t["ts_w"], t["timestamps"], t["padding_mask"], kw["alpha"], kw["max_seq_len"], kw["cfg"], t["timestamps"] is not None)
    torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
    if case == "empty_row":
        assert torch.all(out[0] == 0)


def test_kernel_rejects_what_it_does_not_take(card):
    t, kw = rab_inputs(card)
    args = lambda **o: [o.get(n, t[n]) for n in ("q", "k", "v", "pos_w", "ts_w", "timestamps", "padding_mask")] + [kw["alpha"], kw["max_seq_len"], kw["cfg"]]  # noqa: E731
    with pytest.raises(TypeError, match="float32"):
        rab.hstu_attention_rab(*args(q=t["q"].half()))
    with pytest.raises(ValueError, match="contiguous"):
        rab.hstu_attention_rab(*args(k=t["k"].transpose(2, 3).contiguous().transpose(2, 3)))
    with pytest.raises(ValueError, match="dv"):
        rab.hstu_attention_rab(*args(v=torch.zeros((*t["v"].shape[:3], 160), device=card)))
    with pytest.raises(ValueError, match="is on cpu"):
        rab.hstu_attention_rab(*args(pos_w=t["pos_w"].cpu()))


def test_kernel_has_no_backward_yet(card):
    t, kw = rab_inputs(card)
    q = t["q"].requires_grad_(True)
    out = rab.hstu_attention_rab(q, t["k"], t["v"], t["pos_w"], t["ts_w"], t["timestamps"], t["padding_mask"], kw["alpha"], kw["max_seq_len"], kw["cfg"])
    with pytest.raises(NotImplementedError, match="K2"):
        out.sum().backward()


def test_model_fused_matches_unfused_on_card(card):
    kw = dict(vocab_size=500, d_model=64, n_heads=2, n_layers=2, dqk=32, dv=32, max_seq_len=128, dropout=0.0, num_time_buckets=32)
    fused = HSTUModel(generator=torch.Generator().manual_seed(0), device=card, **kw).eval()
    plain = HSTUModel(use_fused_kernel=False, device=card, **kw).eval()
    plain.load_state_dict(fused.state_dict())
    rng = np.random.default_rng(1)
    toks = rng.integers(1, 500, (4, 100))
    toks[:2, :30] = 0
    tds = np.sort(rng.integers(0, 10**6, (4, 100)), axis=1).astype(np.int32)
    toks, tds = torch.from_numpy(toks).to(card), torch.from_numpy(tds).to(card)
    before = rab.launches
    with torch.inference_mode():
        got, ref = fused(toks, tds), plain(toks, tds)
    assert rab.launches == before + 2
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
