"""The bf16 variants of K1, K2, K2a, K2b and K3 on the card, against their plain bf16 versions.

The rab kernels take bf16 q, k, v and g with f32 tables, K3 bf16 q, k, v with
an f32 or bf16 bias, and they round where the Pallas kernels round
(``ops/cuda/hstu_rab_attention.py``, ``ops/cuda/hstu_attention.py``); the
plain versions (``plain_forward_bf16`` / ``plain_backward_bf16`` of either
module) are held against the Pallas kernels on the CPU in
``tests/test_torch_precision.py`` and ``tests/test_torch_bf16_kernels.py``.
These tests need a CUDA device and skip without one; they import no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_precision.py
"""

import importlib

import numpy as np
import pytest
import torch

from test_torch_cuda_kernels import BIAS_CASES, CASES, bias_inputs, bwd_args, rab_inputs, run_backward, sweep_inputs
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


def kernel_and_plain(t, kw, g, split=False):
    """The bf16 kernels' (out, dq, dk, dv, dpos, dts), the plain bf16 versions', and fp32 plain ones' on the same
    values; the gradients from K2-bf16, or with ``split`` from K2a-bf16 then K2b-bf16."""
    names = ("q", "k", "v", "pos_w", "ts_w", "timestamps", "padding_mask")
    has_time = t["timestamps"] is not None
    out = rab._launch(*(t[n] for n in names), rab.compute_bucket_thresholds(kw["cfg"]).to(t["q"].device), kw["alpha"], kw["max_seq_len"], kw["cfg"])
    got = (out,) + run_backward(bwd_args(t, kw, g), split)
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


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_split_kernels_match_plain(card, case):
    """K2a-bf16 then K2b-bf16 (``_FUSED_BWD[0] = False``) on every case: dq, dk, dv, dpos and dts against the
    plain bf16 backward, each counted on its own counter."""
    t, kw = rab_inputs(card, **CASES[case])
    t = to_bf16(t)
    counters = ("launches_bwd_dq_bf16", "launches_bwd_dkv_bf16", "launches_bwd_bf16", "launches_bwd_dq", "launches_bwd_dkv")
    counts = [getattr(rab, c) for c in counters]
    got, plain, f32 = kernel_and_plain(t, kw, grad_of(t), split=True)
    torch.cuda.synchronize()
    assert [getattr(rab, c) for c in counters] == [counts[0] + 1, counts[1] + 1] + counts[2:]
    assert_bf16_close(got, plain, f32)
    if case == "empty_row":
        assert all(torch.all(x[0] == 0) for x in got[1:4]) and all(torch.isfinite(x.float()).all() for x in got)


def test_bf16_split_backward_twice_agrees_and_dkv_equals_fused(card):
    """K2a-bf16's dq and K2b-bf16's dk, dv are sums in a fixed order: equal bit for bit between two runs; K2b-bf16 is
    K2-bf16's body without dq and the table sums, so its dk, dv equal K2-bf16's bit for bit too."""
    t, kw = rab_inputs(card, b=4, times="shuffled", mask="scattered")
    t = to_bf16(t)
    g = grad_of(t, seed=12)
    first, second = (run_backward(bwd_args(t, kw, g), split=True) for _ in range(2))
    fused = rab.rab_backward_fused(*bwd_args(t, kw, g))
    torch.cuda.synchronize()
    for name, a, b, c in zip(("dq", "dk", "dv"), first, second, fused):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=lambda m: f"{name}: {m}")
        if name != "dq":
            torch.testing.assert_close(a, c, rtol=0, atol=0, msg=lambda m: f"{name} against K2-bf16: {m}")
    assert_bf16_close((first[0],) + first, (second[0],) + second)


def test_bf16_forward_and_fused_dkv_twice_agree(card):
    """K1-bf16 sums its four key splits' partial outputs, and K2-bf16 its four query splits' partial dk, dv, in a
    fixed order with no atomics: two runs agree bit for bit (K2-bf16's dq, summed with atomics, need not)."""
    t, kw = rab_inputs(card, b=4, times="shuffled", mask="scattered")
    t = to_bf16(t)
    g = grad_of(t, seed=13)
    names = ("q", "k", "v", "pos_w", "ts_w", "timestamps", "padding_mask")
    thr = rab.compute_bucket_thresholds(kw["cfg"]).to(card)
    outs = [rab._launch(*(t[n] for n in names), thr, kw["alpha"], kw["max_seq_len"], kw["cfg"]) for _ in range(2)]
    grads = [rab.rab_backward_fused(*bwd_args(t, kw, g)) for _ in range(2)]
    torch.cuda.synchronize()
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0, msg=lambda m: f"out: {m}")
    for name, i in (("dk", 1), ("dv", 2)):
        torch.testing.assert_close(grads[0][i], grads[1][i], rtol=0, atol=0, msg=lambda m: f"{name}: {m}")


SMEM_LIMIT = 232448  # dynamic shared memory a CTA may take on sm_90


def test_bf16_rab_kernels_occupancy(card):
    """The bf16 rab kernels (CTAs of 8 warps: K1-, K2-, K2a- and K2b-bf16) at the serving shape: at least 2 CTAs per
    SM, at most 255 registers, both ring stages.  At L4096 with dqk, dv 128 they still fit.  Where two stages cannot
    fit (a longer L: pw and, for K2- and K2a-bf16, gpos grow with it) they take one and still fit."""
    names = ("hstu_rab_fwd_bf16",) + rab.BWD_ENTRIES_BF16
    for name in names:
        for shape, least in (((256, 32, 32, 256, 128), 2), ((4096, 128, 128, 4096, 128), 1)):
            ctas, regs, smem, stages = rab.launch_shape_bf16(name, *shape)
            assert ctas >= least and 0 < regs <= 255 and 0 < smem <= SMEM_LIMIT, (name, shape, ctas, regs, smem)
            if shape[0] == 256:
                assert stages == 2 and (ctas, regs, smem) == rab.occupancy_bf16(*shape)[name], (name, stages)
    # two 64-row stages of K and V (K1-, K2a-bf16) or of Q and G (K2-bf16) at dqk = dv = 128 take 2 x 2 x 64 x 128 x 2
    # bytes; with pw [L] (and gpos [L]) in f32 beside them, two stages exceed the limit past these L
    for name, l in (("hstu_rab_fwd_bf16", 44_000), ("hstu_rab_bwd_bf16", 21_000), ("hstu_rab_bwd_dq_bf16", 21_000)):
        assert 2 * 2 * 64 * 128 * 2 + (4 if name == "hstu_rab_fwd_bf16" else 8) * l > SMEM_LIMIT
        ctas, regs, smem, stages = rab.launch_shape_bf16(name, l, 128, 128, l, 128)
        assert stages == 1 and ctas >= 1 and smem <= SMEM_LIMIT, (name, l, ctas, smem, stages)


def test_bf16_split_kernels_match_plain_on_one_ring_stage(card):
    """K2a-bf16 with one K/V stage (refilled after a second barrier) and one dts table: at dqk = dv = 128, 12,000
    buckets' tables (tw, thr and the dts sums, 12 bytes a bucket) leave no room for a second stage at L300.  Then
    K2a-bf16 and K2b-bf16 against the plain bf16 backward, as on every case."""
    shape = (300, 128, 128, 300, 12_000)
    assert rab.launch_shape_bf16("hstu_rab_bwd_dq_bf16", *shape)[3] == 1
    t, kw = rab_inputs(card, l=300, maxl=300, d=128, dv=128, nb=12_000, times="shuffled", mask="scattered")
    t = to_bf16(t)
    got, plain, f32 = kernel_and_plain(t, kw, grad_of(t, seed=15), split=True)
    torch.cuda.synchronize()
    assert_bf16_close(got, plain, f32)


@pytest.mark.parametrize("split", [False, True], ids=["K2", "K2a+K2b"])
@pytest.mark.parametrize("l", [63, 130])
def test_bf16_kernels_read_rows_and_masks_at_any_offset(card, l, split):
    """q, k, v and g one element (2 bytes) into their buffers, so no row is 16-byte aligned and the kernels take
    their 2-byte loads; the mask a view one byte into its buffer."""
    t, kw = rab_inputs(card, l=l, times="shuffled", mask="scattered")
    full = torch.ones((t["padding_mask"].shape[0] + 1, l), dtype=torch.bool, device=card)
    full[1:] = t["padding_mask"]
    t["padding_mask"] = full[1:]
    t = to_bf16(t, offset=1)
    assert t["q"].data_ptr() % 16 != 0 and t["padding_mask"].data_ptr() % 4 != 0
    g = grad_of(t, seed=9, offset=1)
    got, plain, f32 = kernel_and_plain(t, kw, g, split)
    torch.cuda.synchronize()
    assert_bf16_close(got, plain, f32)


@pytest.mark.parametrize("split", [False, True], ids=["K2", "K2a+K2b"])
@pytest.mark.parametrize("cfg", rab.SWEEP_CFGS, ids=lambda c: str(tuple(c)))
def test_bf16_bucket_sweep_matches_plain(card, cfg, split):
    """Every bucket threshold -1, 0, +1 and |dt| = 2**31 (``rab.bucket_sweep_stamps``), the plain version on the
    CPU, where the thresholds were computed."""
    t, kw = sweep_inputs(cfg)
    t = to_bf16(t)
    g = grad_of(t, seed=3)
    dev = {n: (x.to(card) if isinstance(x, torch.Tensor) else x) for n, x in t.items()}
    got, _, _ = kernel_and_plain(dev, kw, g.to(card), split)
    torch.cuda.synchronize()
    has_time = True
    plain = (rab.plain_forward_bf16(*(t[n] for n in ("q", "k", "v", "pos_w", "ts_w", "timestamps", "padding_mask")), kw["alpha"], kw["max_seq_len"], kw["cfg"], has_time),)
    plain += rab.plain_backward_bf16(*bwd_args(t, kw, g), has_time)
    assert_bf16_close([x.cpu() for x in got], plain)


def test_kernels_refuse_fp16_and_mixed_dtypes_on_the_card(card):
    """Every kernel takes q, k, v all float32 or all bfloat16 (K3 a bf16 bias only with bf16 q): fp16 and mixed
    dtypes raise on the card, with no cast."""
    t, kw = rab_inputs(card, l=64, maxl=64)
    g = grad_of(t).half()
    h16 = {**t, **{n: t[n].half() for n in ("q", "k", "v")}}
    for fn in (rab.rab_backward_fused, rab.rab_backward_dq, rab.rab_backward_dkv):
        with pytest.raises(TypeError, match="all float32 or all bfloat16"):
            fn(*bwd_args(h16, kw, g))
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        rab.hstu_attention_rab(t["q"].to(BF16), t["k"], t["v"].to(BF16), t["pos_w"], t["ts_w"], t["timestamps"], t["padding_mask"], kw["alpha"], kw["max_seq_len"], kw["cfg"])
    bias = torch.zeros((1, 3, 64, 64), device=card)
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        attn.hstu_attention(h16["q"], h16["k"], h16["v"], bias.half(), t["padding_mask"], kw["alpha"], 64)
    with pytest.raises(TypeError, match="takes a bias of torch.float32,"):
        attn.hstu_attention(t["q"], t["k"], t["v"], bias.to(BF16), t["padding_mask"], kw["alpha"], 64)
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        attn.hstu_attention(t["q"].to(BF16), t["k"].to(BF16), t["v"], bias, t["padding_mask"], kw["alpha"], 64)


# K3-bf16 through the op: every case of the fp32 K3's, with the bias in f32 and in bf16 (a bf16 view one element
# into its buffer where the fp32 case had one 4 bytes in)
def bf16_bias_inputs(card, case, bias_dtype):
    q, k, v, bias, mask, alpha, n = bias_inputs(card, **BIAS_CASES[case])
    q, k, v = (x.to(BF16) for x in (q, k, v))
    if bias_dtype == BF16:
        offset = int(BIAS_CASES[case].get("bias_offset", False))
        buf = torch.full((bias.numel() + offset,), float("nan"), dtype=BF16, device=card)
        buf[offset:] = bias.flatten()
        bias = buf[offset:].view(bias.shape)
    return q, k, v, bias, mask, alpha, n


@pytest.mark.parametrize("bias_dtype", [torch.float32, BF16], ids=["f32_bias", "bf16_bias"])
@pytest.mark.parametrize("case", list(BIAS_CASES))
def test_bf16_attention_kernel_matches_plain(card, case, bias_dtype):
    """K3-bf16 against ``plain_forward_bf16`` (f32 scores and attn, the output rounded) to one bf16 ulp of the
    largest element, and nearer to it than BF16_SHARE of its distance to the fp32 K3 on the same values; a NaN bias
    at the pairs no valid pair reads stays out; a fully masked row gives zeros."""
    q, k, v, bias, mask, alpha, n = bf16_bias_inputs(card, case, bias_dtype)
    before = (attn.launches, attn.launches_bf16)
    out = attn.hstu_attention(q, k, v, bias, mask, alpha, n)
    f32 = attn.hstu_attention(q.float(), k.float(), v.float(), bias.float(), mask, alpha, n)
    torch.cuda.synchronize()
    assert (attn.launches, attn.launches_bf16) == (before[0] + 1, before[1] + 1)
    plain = attn.plain_forward_bf16(q, k, v, bias, mask, alpha, n)
    assert out.dtype == plain.dtype == BF16 and torch.isfinite(out.float()).all()
    a, b, c = out.float(), plain.float(), f32
    torch.testing.assert_close(a, b, rtol=0, atol=ULP_REL * float(b.abs().max()) + 1e-12)
    if float((b - c).norm()) > 0:
        assert float((a - b).norm()) <= BF16_SHARE * float((b - c).norm()), (float((a - b).norm()), float((b - c).norm()))
    if case == "empty_row":
        assert torch.all(out[0] == 0)


@pytest.mark.parametrize("shared", [False, True], ids=["per_batch", "shared"])
def test_bf16_attention_kernel_twice_agrees_and_backs_up(card, shared):
    """K3-bf16 uses no atomics: two runs agree bit for bit; the op's backward on bf16 leaves (autograd of the plain
    version, as JAX's) gives gradients in the leaves' dtypes, dbias in the bias's shape."""
    q, k, v, bias, mask, alpha, n = bias_inputs(card, b=4, mask="scattered", shared=shared)
    leaves = [x.to(BF16).requires_grad_(True) for x in (q, k, v)] + [bias.requires_grad_(True)]
    first = attn.hstu_attention(*leaves, mask, alpha, n)
    second = attn.hstu_attention(*(x.detach() for x in leaves), mask, alpha, n)
    first.backward(grad_of({"v": first}, seed=5))
    torch.cuda.synchronize()
    torch.testing.assert_close(first.detach(), second, rtol=0, atol=0)
    assert [x.grad.dtype for x in leaves] == [BF16] * 3 + [torch.float32] and leaves[3].grad.shape == bias.shape
    assert all(torch.isfinite(x.grad.float()).all() for x in leaves)


def test_bf16_attention_kernel_occupancy(card):
    """K3-bf16 (CTAs of 8 warps) with an f32 or a bf16 bias: at least 2 CTAs per SM and both ring stages at the
    serving shape; its shared memory does not grow with L; dqk 256 with dv 128 fits, with both stages."""
    for bias_bf16 in (False, True):
        ctas, regs, smem, stages = attn.occupancy_bf16(256, 32, 32, bias_bf16)
        assert ctas >= 2 and 0 < regs <= 255 and stages == 2 and smem == attn.occupancy_bf16(4096, 32, 32, bias_bf16)[2]
        ctas, regs, smem, stages = attn.occupancy_bf16(1024, 256, 128, bias_bf16)
        assert ctas >= 1 and smem <= SMEM_LIMIT and stages == 2


@pytest.mark.parametrize("l", [130, 258])
@pytest.mark.parametrize("bias_dtype", [torch.float32, BF16], ids=["f32_bias", "bf16_bias"])
def test_bf16_attention_kernel_takes_the_4_byte_bias_copies(card, bias_dtype, l):
    """An even L that is not a multiple of 4: K3-bf16 copies the bias in 4-byte chunks (one f32, or two bf16), not
    16-byte ones; NaN in the upper triangle and at the masked keys stays out, and the output holds against the plain
    bf16 version as on every case."""
    q, k, v, bias, mask, alpha, n = bias_inputs(card, l=l, mask="scattered", nan=True)
    q, k, v, bias = q.to(BF16), k.to(BF16), v.to(BF16), bias.to(bias_dtype)
    assert l % 4 and not l % 2 and bias.data_ptr() % 4 == 0
    out = attn.hstu_attention(q, k, v, bias, mask, alpha, n)
    plain = attn.plain_forward_bf16(q, k, v, bias, mask, alpha, n)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), plain.float(), rtol=0, atol=ULP_REL * float(plain.float().abs().max()) + 1e-12)


def hstu_step_card_vs_cpu(card, split):
    """A small HSTU under ``SeqTrainer(precision="bf16")``: the chunked loss and every gradient of one step on the
    card against the CPU's (the plain bf16 attention there), through K1-bf16 and K2-bf16, or with ``split`` through
    K2a-bf16 and K2b-bf16 (``_FUSED_BWD[0] = False``).  The tolerance: a few bf16 ulps of each tensor's largest
    gradient (cuBLAS and the kernels sum in other orders than the CPU)."""
    kw = dict(vocab_size=60, d_model=32, n_heads=2, n_layers=2, dqk=16, dv=16, max_seq_len=64, dropout=0.0, num_time_buckets=16)
    rng = np.random.default_rng(0)
    toks = np.zeros((4, 64), np.int64)
    for i, n in enumerate((64, 40, 17, 3)):
        toks[i, :n] = rng.integers(1, 60, n)
    tds = np.sort(rng.integers(0, 10**6, (4, 64)), axis=1).astype(np.int32)
    tgts = rng.integers(1, 60, 4)
    counters = ("launches_bf16", "launches_bwd_bf16", "launches_bwd_dq_bf16", "launches_bwd_dkv_bf16")
    expected = (2, 0, 2, 2) if split else (2, 2, 0, 0)
    grads, losses = [], []
    rab._FUSED_BWD[0] = not split
    try:
        for device in ("cpu", card):
            torch.manual_seed(0)
            model = HSTUModel(**kw, generator=torch.Generator().manual_seed(0))
            trainer = SeqTrainer(model, vocab_chunk_size=16, precision="bf16", device=device)
            model.train()
            counts = [getattr(rab, c) for c in counters]
            with precision_scope("bf16"):
                loss = trainer.loss_fn(*(torch.from_numpy(a).to(device) for a in (toks, tds, tgts)))
            loss.backward()
            if device != "cpu":
                torch.cuda.synchronize()
                assert tuple(getattr(rab, c) - n for c, n in zip(counters, counts)) == expected
            losses.append(float(loss))
            grads.append({n: p.grad.detach().cpu() for n, p in model.named_parameters()})
    finally:
        rab._FUSED_BWD[0] = True
    np.testing.assert_allclose(losses[1], losses[0], rtol=2e-3)
    for name, ref in grads[0].items():
        torch.testing.assert_close(grads[1][name], ref, rtol=0, atol=4 * ULP_REL * float(ref.abs().max()) + 1e-12, msg=lambda m: f"{name}: {m}")


def test_bf16_hstu_split_step_on_the_card_matches_the_cpu(card):
    hstu_step_card_vs_cpu(card, split=True)


def test_bf16_hstu_step_on_the_card_matches_the_cpu(card):
    hstu_step_card_vs_cpu(card, split=False)
