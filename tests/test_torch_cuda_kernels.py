"""The port's CUDA kernels on the card, against their plain PyTorch versions.

These tests need a CUDA device and skip without one (the kernels have no CPU
mode).  They import torch and numpy only, so they also run where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: ``tests/conftest.py`` sets up JAX.)
"""

import importlib
import math

import numpy as np
import pytest
import torch

from torch_rechub_tpu_torch.models.generative import HSTUModel
from torch_rechub_tpu_torch.ops.cuda import hstu_rab_attention as rab

# the package binds the name hstu_attention to the op: the module by its full name
attn = importlib.import_module("torch_rechub_tpu_torch.ops.cuda.hstu_attention")

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


# Backward kernels against the plain backward (autograd of dense_forward).
# dq, dk, dv: sums of up to L fp32 products, as the forward, but K2's dq is
# a sum of per-tile fp32 atomics whose order changes from run to run.  dpos
# and dts sum up to B*L^2/2 terms of either sign into one slot, in another
# order than autograd's scatter-add: their error scales with the largest
# slot, hence an absolute tolerance relative to max |ref| of the table.
BWD_RTOL, BWD_ATOL = 1e-4, 1e-5
TABLE_RTOL, TABLE_ATOL_REL = 1e-4, 1e-5
GRAD_NAMES = ("dq", "dk", "dv", "dpos", "dts")


def assert_grads_close(got, ref, names=GRAD_NAMES):
    for name, a, b in zip(names, got, ref, strict=True):
        if name in ("dpos", "dts"):
            torch.testing.assert_close(a, b, rtol=TABLE_RTOL, atol=TABLE_ATOL_REL * float(b.abs().max()) + 1e-12, msg=lambda m: f"{name}: {m}")
        else:
            torch.testing.assert_close(a, b, rtol=BWD_RTOL, atol=BWD_ATOL, msg=lambda m: f"{name}: {m}")


def bwd_args(t, kw, g):
    return (t["q"], t["k"], t["v"], g, t["pos_w"], t["ts_w"], t["timestamps"], t["padding_mask"], kw["alpha"], kw["max_seq_len"], kw["cfg"])


@pytest.mark.parametrize("split", [False, True], ids=["K2", "K2a+K2b"])
@pytest.mark.parametrize("case", list(CASES))
def test_backward_kernels_match_plain(card, case, split):
    t, kw = rab_inputs(card, **CASES[case])
    g = torch.from_numpy(np.random.default_rng(7).normal(size=t["v"].shape).astype(np.float32)).to(card)
    args = bwd_args(t, kw, g)
    counts = (rab.launches_bwd, rab.launches_bwd_dq, rab.launches_bwd_dkv)
    if split:
        dq, dpos, dts = rab.rab_backward_dq(*args)
        dk, dv = rab.rab_backward_dkv(*args)
        got = (dq, dk, dv, dpos, dts)
    else:
        got = rab.rab_backward_fused(*args)
    torch.cuda.synchronize()
    assert (rab.launches_bwd, rab.launches_bwd_dq, rab.launches_bwd_dkv) == (counts[0] + (not split), counts[1] + split, counts[2] + split)
    ref = rab.dense_backward(*args, t["timestamps"] is not None)
    assert_grads_close(got, ref)
    if case == "empty_row":
        assert torch.all(got[0][0] == 0) and all(torch.isfinite(x).all() for x in got)


@pytest.mark.parametrize("split", [False, True], ids=["K2", "K2a+K2b"])
def test_autograd_runs_the_backward_kernels(card, split):
    t, kw = rab_inputs(card, times="shuffled", mask="scattered")
    rab._FUSED_BWD[0] = not split
    try:
        check_autograd(card, t, kw, split)
    finally:
        rab._FUSED_BWD[0] = True


def check_autograd(card, t, kw, split):
    leaves = [t[n].clone().requires_grad_(True) for n in ("q", "k", "v", "pos_w", "ts_w")]
    g = torch.from_numpy(np.random.default_rng(8).normal(size=t["v"].shape).astype(np.float32)).to(card)
    counts = (rab.launches, rab.launches_bwd, rab.launches_bwd_dq, rab.launches_bwd_dkv)
    out = rab.hstu_attention_rab(*leaves, t["timestamps"], t["padding_mask"], kw["alpha"], kw["max_seq_len"], kw["cfg"])
    # a non-contiguous output gradient, as the layer's transpose + reshape gives
    out.transpose(1, 2).contiguous().transpose(1, 2).backward(g)
    torch.cuda.synchronize()
    assert (rab.launches, rab.launches_bwd, rab.launches_bwd_dq, rab.launches_bwd_dkv) == (counts[0] + 1, counts[1] + (not split), counts[2] + split, counts[3] + split)
    ref = rab.dense_backward(*(t[n] for n in ("q", "k", "v")), g, t["pos_w"], t["ts_w"], t["timestamps"], t["padding_mask"], kw["alpha"], kw["max_seq_len"], kw["cfg"], True)
    assert_grads_close([x.grad for x in leaves], ref)


def test_backward_kernels_reject_what_they_do_not_take(card):
    t, kw = rab_inputs(card)
    g = torch.zeros_like(t["v"])
    args = lambda **o: [o.get(n, x) for n, x in zip(("q", "k", "v", "g", "pos_w", "ts_w", "timestamps", "padding_mask"), bwd_args(t, kw, g))] + [kw["alpha"], kw["max_seq_len"], kw["cfg"]]  # noqa: E731
    for fn in (rab.rab_backward_fused, rab.rab_backward_dq, rab.rab_backward_dkv):
        with pytest.raises(ValueError, match="output gradient"):
            fn(*args(g=g.transpose(2, 3).contiguous().transpose(2, 3)))
        with pytest.raises(ValueError, match="output gradient"):
            fn(*args(g=g.double()))
        with pytest.raises(TypeError, match="float32"):
            fn(*args(k=t["k"].half()))
        with pytest.raises(ValueError, match="is on cpu"):
            fn(*args(ts_w=t["ts_w"].cpu()))
        wide = torch.zeros((*t["q"].shape[:3], 160), device=card)
        with pytest.raises(ValueError, match="dqk, dv <= 128"):
            fn(*args(q=wide, k=wide))


def test_model_gradients_fused_match_unfused_on_card(card):
    kw = dict(vocab_size=500, d_model=64, n_heads=2, n_layers=2, dqk=32, dv=32, max_seq_len=128, dropout=0.0, num_time_buckets=32)
    fused = HSTUModel(generator=torch.Generator().manual_seed(0), device=card, **kw)
    plain = HSTUModel(use_fused_kernel=False, device=card, **kw)
    plain.load_state_dict(fused.state_dict())
    rng = np.random.default_rng(2)
    toks = rng.integers(1, 500, (4, 100))
    toks[:2, :30] = 0
    tds = np.sort(rng.integers(0, 10**6, (4, 100)), axis=1).astype(np.int32)
    toks, tds = torch.from_numpy(toks).to(card), torch.from_numpy(tds).to(card)
    weights = torch.from_numpy(rng.normal(size=(4, 100, 500)).astype(np.float32)).to(card)
    before = rab.launches_bwd
    for model in (fused, plain):
        (model(toks, tds) * weights).sum().backward()
    torch.cuda.synchronize()
    assert rab.launches_bwd == before + 2
    for (name, a), b in zip(fused.named_parameters(), plain.parameters(), strict=True):
        # gradients through two layers and the vocab projection: the table
        # tolerance (relative to the largest element) for every tensor
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-4 * float(b.grad.abs().max()) + 1e-12, msg=lambda m: f"{name}: {m}")


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


# K3, the materialised-bias op: the kernel against dense_forward (same
# tolerance as K1), its gradients, and against K1 on a materialised rab.
BIAS_CASES = {
    "per_batch_suffix": dict(),
    "shared_suffix": dict(shared=True),
    "per_batch_scattered": dict(mask="scattered"),
    "shared_scattered": dict(mask="scattered", shared=True),
    "empty_row": dict(mask="empty_row"),
    "no_mask": dict(mask=None),
    "shared_no_mask": dict(mask=None, shared=True),
    "ragged_200": dict(l=200),
    "ragged_77_shared": dict(l=77, shared=True),
    "dqk8_dv16": dict(d=8, dv=16),
    "dqk12_dv20_ragged": dict(l=131, d=12, dv=20),
    "dqk64_dv128": dict(l=128, d=64, dv=128),
    "nan_upper_triangle": dict(nan=True),
    "long_1024": dict(b=1, l=1024),
}


def bias_inputs(device, b=2, h=3, l=256, d=32, dv=32, seed=0, mask="suffix", shared=False, nan=False):
    t, _ = rab_inputs(device, b=b, h=h, l=l, maxl=l, d=d, dv=dv, seed=seed, times=None, mask=mask)
    rng = np.random.default_rng(seed + 100)
    bias = torch.from_numpy((rng.normal(size=(1 if shared else b, h, l, l)) * 0.1).astype(np.float32)).to(device)
    if nan:  # NaN where no valid pair reads: the upper triangle and the masked keys
        bias.masked_fill_(~torch.tril(torch.ones((l, l), dtype=torch.bool, device=device)), float("nan"))
        bias.masked_fill_(~t["padding_mask"][:, None, None, :], float("nan"))
    return t["q"], t["k"], t["v"], bias, t["padding_mask"], 1.0 / math.sqrt(d), float(l)


@pytest.mark.parametrize("case", list(BIAS_CASES))
def test_attention_kernel_matches_plain(card, case):
    q, k, v, bias, mask, alpha, n = bias_inputs(card, **BIAS_CASES[case])
    before = attn.launches
    out = attn.hstu_attention(q, k, v, bias, mask, alpha, n)
    torch.cuda.synchronize()
    assert attn.launches == before + 1
    torch.testing.assert_close(out, attn.dense_forward(q, k, v, bias, mask, alpha, n), rtol=RTOL, atol=ATOL)
    if case == "empty_row":
        assert torch.all(out[0] == 0)


@pytest.mark.parametrize("shared", [False, True], ids=["per_batch", "shared"])
def test_attention_gradients_on_card(card, shared):
    q, k, v, bias, mask, alpha, n = bias_inputs(card, mask="scattered", shared=shared)
    g = torch.from_numpy(np.random.default_rng(9).normal(size=v.shape).astype(np.float32)).to(card)
    got, ref = ([x.clone().requires_grad_(True) for x in (q, k, v, bias)] for _ in range(2))
    before = attn.launches
    attn.hstu_attention(*got, mask, alpha, n).backward(g)
    attn.dense_forward(*ref, mask, alpha, n).backward(g)
    torch.cuda.synchronize()
    assert attn.launches == before + 1
    assert got[3].grad.shape == bias.shape
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, ref):
        torch.testing.assert_close(a.grad, b.grad, rtol=BWD_RTOL, atol=BWD_ATOL, msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("times", ["sorted", None])
def test_attention_kernel_on_a_dense_rab_matches_k1(card, times):
    t, kw = rab_inputs(card, times=times, mask="scattered")
    bias = rab.dense_bias(t["pos_w"], t["ts_w"], t["timestamps"], t["q"].shape[2], kw["max_seq_len"], kw["cfg"], times is not None).contiguous()
    out = attn.hstu_attention(t["q"], t["k"], t["v"], bias, t["padding_mask"], kw["alpha"], float(kw["max_seq_len"]))
    k1 = rab.hstu_attention_rab(t["q"], t["k"], t["v"], t["pos_w"], t["ts_w"], t["timestamps"], t["padding_mask"], kw["alpha"], kw["max_seq_len"], kw["cfg"])
    torch.cuda.synchronize()
    assert bias.shape[0] == (t["q"].shape[0] if times else 1)
    torch.testing.assert_close(out, k1, rtol=RTOL, atol=ATOL)


def test_attention_kernel_rejects_what_it_does_not_take(card):
    q, k, v, bias, mask, alpha, n = bias_inputs(card, b=3)
    with pytest.raises(TypeError, match="float32"):
        attn.hstu_attention(q.to(torch.bfloat16), k, v, bias, mask, alpha, n)
    with pytest.raises(ValueError, match="contiguous"):
        attn.hstu_attention(q, k, v, bias.transpose(2, 3), mask, alpha, n)
    with pytest.raises(ValueError, match="bias must be"):
        attn.hstu_attention(q, k, v, bias[:2].contiguous(), mask, alpha, n)
    with pytest.raises(ValueError, match="dv"):
        attn.hstu_attention(q, k, torch.zeros((*v.shape[:3], 160), device=card), bias, mask, alpha, n)
    with pytest.raises(ValueError, match="is on cpu"):
        attn.hstu_attention(q, k, v, bias.cpu(), mask, alpha, n)
