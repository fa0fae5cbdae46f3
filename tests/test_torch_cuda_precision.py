"""The bf16 variants of K1 and K2 on the card, against their plain bf16 versions.

The kernels take bf16 q, k, v and g with f32 tables and round where the
Pallas kernels round (``ops/cuda/hstu_rab_attention.py``); the plain
versions (``plain_forward_bf16`` / ``plain_backward_bf16``) are held
against the Pallas kernels on the CPU in ``tests/test_torch_precision.py``.
These tests need a CUDA device and skip without one; they import no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_precision.py
"""

import importlib

import numpy as np
import pytest
import torch

from test_torch_cuda_kernels import CASES, bwd_args, rab_inputs, sweep_inputs
from torch_rechub_tpu_torch.basic.precision import precision_scope
from torch_rechub_tpu_torch.models.generative import HSTUModel
from torch_rechub_tpu_torch.ops.cuda import hstu_rab_attention as rab
from torch_rechub_tpu_torch.trainers import SeqTrainer

attn = importlib.import_module("torch_rechub_tpu_torch.ops.cuda.hstu_attention")

pytestmark = pytest.mark.cuda

BF16 = torch.bfloat16
# out, dq, dk, dv (bf16): one bf16 ulp of the largest element, since a rounding of attn or ds, or of an
# f32 sum taken in another order, may flip; dpos, dts (f32): sums of up to B*L^2/2 terms in another order
ULP_REL = 2**-7
TABLE_RTOL, TABLE_ATOL_REL = 1e-4, 2e-4
# the kernels round as the plain version does: their distance to it is at most this share of the plain
# version's distance to the fp32 result (a kernel that stayed in fp32 fails)
BF16_SHARE = 0.25
NAMES = ("out", "dq", "dk", "dv", "dpos", "dts")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def to_bf16(t, offset=0):
    """q, k, v as bf16 (at ``offset`` elements into a buffer: a view whose rows start anywhere)."""
    out = dict(t)
    for n in ("q", "k", "v"):
        buf = torch.empty(t[n].numel() + offset, dtype=BF16, device=t[n].device)
        out[n] = buf[offset:].view(t[n].shape)
        out[n].copy_(t[n])
    return out


def grad_of(t, seed=7, offset=0):
    g = torch.from_numpy(np.random.default_rng(seed).normal(size=t["v"].shape).astype(np.float32)).to(t["v"].device)
    buf = torch.empty(g.numel() + offset, dtype=BF16, device=g.device)
    out = buf[offset:].view(g.shape)
    out.copy_(g)
    return out


def kernel_and_plain(t, kw, g):
    """The bf16 kernels' (out, dq, dk, dv, dpos, dts), the plain bf16 versions', and fp32 plain ones' on the same values."""
    names = ("q", "k", "v", "pos_w", "ts_w", "timestamps", "padding_mask")
    has_time = t["timestamps"] is not None
    out = rab._launch(*(t[n] for n in names), rab.compute_bucket_thresholds(kw["cfg"]).to(t["q"].device), kw["alpha"], kw["max_seq_len"], kw["cfg"])
    got = (out,) + rab.rab_backward_fused(*bwd_args(t, kw, g))
    plain = (rab.plain_forward_bf16(*(t[n] for n in names), kw["alpha"], kw["max_seq_len"], kw["cfg"], has_time),) + rab.plain_backward_bf16(*bwd_args(t, kw, g), has_time)
    t32 = {n: (t[n].float() if n in ("q", "k", "v") else t[n]) for n in names}
    f32 = (rab.dense_forward(*(t32[n] for n in names), kw["alpha"], kw["max_seq_len"], kw["cfg"], has_time),)
    f32 += rab.dense_backward(*(t32[n] for n in ("q", "k", "v")), g.float(), *(t32[n] for n in names[3:]), kw["alpha"], kw["max_seq_len"], kw["cfg"], has_time)
    return got, plain, f32


def assert_bf16_close(got, plain, f32=None):
    for name, a, b, c in zip(NAMES, got, plain, f32 or plain):
        assert a.dtype == b.dtype == (torch.float32 if name in ("dpos", "dts") else BF16), (name, a.dtype, b.dtype)
        a, b, c = a.float(), b.float(), c.float()
        scale = float(b.abs().max())
        if name in ("dpos", "dts"):
            torch.testing.assert_close(a, b, rtol=TABLE_RTOL, atol=TABLE_ATOL_REL * scale + 1e-12, msg=lambda m: f"{name}: {m}")
            continue
        torch.testing.assert_close(a, b, rtol=0, atol=ULP_REL * scale + 1e-12, msg=lambda m: f"{name}: {m}")
        if f32 is not None and float((b - c).norm()) > 0:
            assert float((a - b).norm()) <= BF16_SHARE * float((b - c).norm()), (name, float((a - b).norm()), float((b - c).norm()))


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_kernels_match_plain(card, case):
    t, kw = rab_inputs(card, **CASES[case])
    t = to_bf16(t)
    counts = (rab.launches_bf16, rab.launches_bwd_bf16, rab.launches, rab.launches_bwd)
    got, plain, f32 = kernel_and_plain(t, kw, grad_of(t))
    torch.cuda.synchronize()
    assert (rab.launches_bf16, rab.launches_bwd_bf16, rab.launches, rab.launches_bwd) == (counts[0] + 1, counts[1] + 1, counts[2], counts[3])
    assert_bf16_close(got, plain, f32)
    if case == "empty_row":
        assert torch.all(got[0][0] == 0) and all(torch.isfinite(x.float()).all() for x in got)


@pytest.mark.parametrize("l", [40, 130])
def test_bf16_forward_matches_plain_on_wide_heads(card, l):
    """dqk 256, dv 128: K1-bf16's widest heads (the backward takes dqk, dv <= 128)."""
    t, kw = rab_inputs(card, l=l, d=256, dv=128, times="shuffled", mask="scattered")
    t = to_bf16(t)
    names = ("q", "k", "v", "pos_w", "ts_w", "timestamps", "padding_mask")
    out = rab.hstu_attention_rab(*(t[n] for n in names), kw["alpha"], kw["max_seq_len"], kw["cfg"])
    plain = rab.plain_forward_bf16(*(t[n] for n in names), kw["alpha"], kw["max_seq_len"], kw["cfg"], True)
    torch.cuda.synchronize()
    assert out.dtype == BF16
    torch.testing.assert_close(out.float(), plain.float(), rtol=0, atol=ULP_REL * float(plain.float().abs().max()))


def test_bf16_autograd_runs_the_bf16_kernels(card):
    """The op's autograd Function on bf16 leaves: K1-bf16 forward, K2-bf16 backward, bf16 q/k/v gradients and
    f32 table gradients."""
    t, kw = rab_inputs(card, times="shuffled", mask="scattered")
    t = to_bf16(t)
    leaves = [t[n].clone().requires_grad_(True) for n in ("q", "k", "v", "pos_w", "ts_w")]
    g = grad_of(t, seed=8)
    counts = (rab.launches_bf16, rab.launches_bwd_bf16)
    out = rab.hstu_attention_rab(*leaves, t["timestamps"], t["padding_mask"], kw["alpha"], kw["max_seq_len"], kw["cfg"])
    out.transpose(1, 2).contiguous().transpose(1, 2).backward(g)  # a non-contiguous gradient, as the layer gives
    torch.cuda.synchronize()
    assert (rab.launches_bf16, rab.launches_bwd_bf16) == (counts[0] + 1, counts[1] + 1)
    got = (out.detach(),) + tuple(x.grad for x in leaves)
    _, plain, _ = kernel_and_plain(t, kw, g)
    assert_bf16_close(got, plain)


@pytest.mark.parametrize("l", [63, 130])
def test_bf16_kernels_read_rows_and_masks_at_any_offset(card, l):
    """q, k, v and g one element (2 bytes) into their buffers, so no row is 16-byte aligned and the kernels take
    their 2-byte loads; the mask a view one byte into its buffer."""
    t, kw = rab_inputs(card, l=l, times="shuffled", mask="scattered")
    full = torch.ones((t["padding_mask"].shape[0] + 1, l), dtype=torch.bool, device=card)
    full[1:] = t["padding_mask"]
    t["padding_mask"] = full[1:]
    t = to_bf16(t, offset=1)
    assert t["q"].data_ptr() % 16 != 0 and t["padding_mask"].data_ptr() % 4 != 0
    g = grad_of(t, seed=9, offset=1)
    got, plain, f32 = kernel_and_plain(t, kw, g)
    torch.cuda.synchronize()
    assert_bf16_close(got, plain, f32)


@pytest.mark.parametrize("cfg", rab.SWEEP_CFGS, ids=lambda c: str(tuple(c)))
def test_bf16_bucket_sweep_matches_plain(card, cfg):
    """Every bucket threshold -1, 0, +1 and |dt| = 2**31 (``rab.bucket_sweep_stamps``), the plain version on the
    CPU, where the thresholds were computed."""
    t, kw = sweep_inputs(cfg)
    t = to_bf16(t)
    g = grad_of(t, seed=3)
    dev = {n: (x.to(card) if isinstance(x, torch.Tensor) else x) for n, x in t.items()}
    got, _, _ = kernel_and_plain(dev, kw, g.to(card))
    torch.cuda.synchronize()
    has_time = True
    plain = (rab.plain_forward_bf16(*(t[n] for n in ("q", "k", "v", "pos_w", "ts_w", "timestamps", "padding_mask")), kw["alpha"], kw["max_seq_len"], kw["cfg"], has_time),)
    plain += rab.plain_backward_bf16(*bwd_args(t, kw, g), has_time)
    assert_bf16_close([x.cpu() for x in got], plain)


def test_kernels_without_a_bf16_variant_raise_on_the_card(card):
    """K2a + K2b (``_FUSED_BWD[0] = False``) and K3 refuse bf16 on the card, naming ROADMAP queue 2: no cast."""
    t, kw = rab_inputs(card, l=64, maxl=64)
    t = to_bf16(t)
    g = grad_of(t)
    for fn in (rab.rab_backward_dq, rab.rab_backward_dkv):
        with pytest.raises(TypeError, match="ROADMAP queue 2"):
            fn(*bwd_args(t, kw, g))
    with pytest.raises(TypeError, match="ROADMAP queue 2"):
        attn.hstu_attention(t["q"], t["k"], t["v"], torch.zeros((1, 3, 64, 64), dtype=BF16, device=card), t["padding_mask"], kw["alpha"], 64)
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        rab.hstu_attention_rab(t["q"], t["k"].float(), t["v"], t["pos_w"], t["ts_w"], t["timestamps"], t["padding_mask"], kw["alpha"], kw["max_seq_len"], kw["cfg"])


def test_bf16_hstu_step_on_the_card_matches_the_cpu(card):
    """A small HSTU under ``SeqTrainer(precision="bf16")``: the chunked loss and every gradient of one step on the
    card against the CPU's (the plain bf16 attention there), through the bf16 kernels.  The tolerance: a few bf16
    ulps of each tensor's largest gradient (cuBLAS and the kernels sum in other orders than the CPU)."""
    kw = dict(vocab_size=60, d_model=32, n_heads=2, n_layers=2, dqk=16, dv=16, max_seq_len=64, dropout=0.0, num_time_buckets=16)
    rng = np.random.default_rng(0)
    toks = np.zeros((4, 64), np.int64)
    for i, n in enumerate((64, 40, 17, 3)):
        toks[i, :n] = rng.integers(1, 60, n)
    tds = np.sort(rng.integers(0, 10**6, (4, 64)), axis=1).astype(np.int32)
    tgts = rng.integers(1, 60, 4)
    grads, losses = [], []
    for device in ("cpu", card):
        torch.manual_seed(0)
        model = HSTUModel(**kw, generator=torch.Generator().manual_seed(0))
        trainer = SeqTrainer(model, vocab_chunk_size=16, precision="bf16", device=device)
        model.train()
        counts = (rab.launches_bf16, rab.launches_bwd_bf16)
        with precision_scope("bf16"):
            loss = trainer.loss_fn(*(torch.from_numpy(a).to(device) for a in (toks, tds, tgts)))
        loss.backward()
        if device != "cpu":
            torch.cuda.synchronize()
            assert (rab.launches_bf16 - counts[0], rab.launches_bwd_bf16 - counts[1]) == (2, 2)
        losses.append(float(loss))
        grads.append({n: p.grad.detach().cpu() for n, p in model.named_parameters()})
    np.testing.assert_allclose(losses[1], losses[0], rtol=2e-3)
    for name, ref in grads[0].items():
        torch.testing.assert_close(grads[1][name], ref, rtol=0, atol=4 * ULP_REL * float(ref.abs().max()) + 1e-12, msg=lambda m: f"{name}: {m}")
