"""The width-tiled variants and the fixed-order table gradients on the card.

Every head width the JAX op takes runs through a hand-written kernel: past
the tensor-core kernels' widths (forward dv > 128 or dqk > 256, backward
dqk or dv > 128) K1, K2, K2a, K2b and K3 take their width-tiled variants
(``csrc/hstu_wide.cuh``), in fp32 and bf16, held here against the plain
versions.  Long sequences whose shared memory does not fit take the same
variants.  K2's and K2a's dpos and dts are summed in a fixed order: two
launches agree bit for bit, and so does split-path training under
deterministic algorithms.

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_wide.py
"""

import os

import numpy as np
import pytest
import torch

from test_torch_cuda_kernels import ATOL, RTOL, assert_grads_close, attn, bias_inputs, bwd_args, rab_inputs, run_backward
from test_torch_cuda_precision import assert_bf16_close, grad_of, kernel_and_plain, to_bf16
from torch_rechub_tpu_torch.ops.cuda import hstu_rab_attention as rab

pytestmark = pytest.mark.cuda

WIDTHS = [(160, 160), (256, 256), (320, 64), (64, 320), (384, 384)]
NAMES = ("q", "k", "v", "pos_w", "ts_w", "timestamps", "padding_mask")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def wide_inputs(card, dqk, dv, l=200, b=2, h=2):
    t, kw = rab_inputs(card, b=b, h=h, l=l, maxl=max(l, 256), d=dqk, dv=dv, times="shuffled", mask="scattered")
    return t, kw


@pytest.mark.parametrize("split", [False, True], ids=["K2", "K2a+K2b"])
@pytest.mark.parametrize("dqk,dv", WIDTHS, ids=lambda x: str(x))
def test_wide_heads_match_plain_fp32(card, dqk, dv, split):
    t, kw = wide_inputs(card, dqk, dv)
    before = dict(rab.launches_wide)
    out = rab.hstu_attention_rab(*(t[n] for n in NAMES), kw["alpha"], kw["max_seq_len"], kw["cfg"])
    g = torch.from_numpy(np.random.default_rng(7).normal(size=t["v"].shape).astype(np.float32)).to(card)
    got = run_backward(bwd_args(t, kw, g), split)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, rab.dense_forward(*(t[n] for n in NAMES), kw["alpha"], kw["max_seq_len"], kw["cfg"], True), rtol=RTOL, atol=ATOL)
    assert_grads_close(got, rab.dense_backward(*bwd_args(t, kw, g), True))
    wide = {name: n - before.get(name, 0) for name, n in rab.launches_wide.items()}
    entries = ("hstu_rab_bwd_dq", "hstu_rab_bwd_dkv") if split else ("hstu_rab_bwd",)
    assert all(wide.get(e) == 1 for e in entries), wide
    assert wide.get("hstu_rab_fwd") == (1 if dv > 128 or dqk > 256 else None), wide


@pytest.mark.parametrize("split", [False, True], ids=["K2", "K2a+K2b"])
@pytest.mark.parametrize("dqk,dv", WIDTHS, ids=lambda x: str(x))
def test_wide_heads_match_plain_bf16(card, dqk, dv, split):
    t, kw = wide_inputs(card, dqk, dv)
    t = to_bf16(t)
    got, plain, f32 = kernel_and_plain(t, kw, grad_of(t), split)
    torch.cuda.synchronize()
    assert_bf16_close(got, plain, f32)


@pytest.mark.parametrize("dqk,dv", WIDTHS, ids=lambda x: str(x))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_wide_heads_k3_matches_plain(card, dqk, dv, dtype):
    q, k, v, bias, mask, alpha, n = bias_inputs(card, b=2, h=2, l=200, d=dqk, dv=dv, mask="scattered")
    name = "hstu_attn_fwd" if dtype == torch.float32 else "hstu_attn_fwd_bf16"
    before = attn.launches_wide.get(name, 0)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    with torch.no_grad():
        out = attn.hstu_attention(q, k, v, bias, mask, alpha, n)
    torch.cuda.synchronize()
    assert attn.launches_wide.get(name, 0) == before + (dv > 128 or dqk > 256)
    if dtype == torch.float32:
        torch.testing.assert_close(out, attn.dense_forward(q, k, v, bias, mask, alpha, n), rtol=RTOL, atol=ATOL)
    else:
        plain = attn.plain_forward_bf16(q, k, v, bias, mask, alpha, n).float()
        torch.testing.assert_close(out.float(), plain, rtol=0, atol=2**-7 * float(plain.abs().max()))


def test_occupancy_reports_the_variant(card):
    narrow = rab.occupancy(256, 32, 32, 256, 128)
    assert {v[3] for v in narrow.values()} == {rab.TENSOR_CORE}
    wide = rab.occupancy(256, 256, 256, 256, 128)
    assert {v[3] for v in wide.values()} == {rab.WIDE} and all(v[0] >= 1 for v in wide.values())
    assert rab.launch_shape_bf16("hstu_rab_bwd_dq_bf16", 256, 160, 64, 256, 128)[4] == rab.WIDE
    assert rab.launch_shape_bf16("hstu_rab_fwd_bf16", 256, 256, 128, 256, 128)[4] == rab.TENSOR_CORE
    assert attn.occupancy(256, 64, 320)[3] == attn.occupancy_bf16(256, 320, 64)[4] == rab.WIDE


@pytest.mark.parametrize("l", [1024, 2048, 4096])
@pytest.mark.parametrize("d", [64, 256])
def test_long_sequences_run(card, d, l):
    """L up to 4096 at dqk = dv = 64 and 256: every kernel launches and matches the plain version at the longest;
    at d64 through the tensor-core kernels, at d256 through the width-tiled variants."""
    variant = rab.WIDE if d > 128 else rab.TENSOR_CORE
    shape = (l, d, d, l, 16)
    assert {v[3] for v in rab.occupancy(*shape).values()} == {variant}
    assert {v[-1] for v in rab.occupancy_bf16(*shape).values()} == {variant}
    t, kw = rab_inputs(card, b=1, h=1, l=l, maxl=l, d=d, dv=d, times="sorted", mask="suffix")
    g = torch.from_numpy(np.random.default_rng(9).normal(size=t["v"].shape).astype(np.float32)).to(card)
    out = rab.hstu_attention_rab(*(t[n] for n in NAMES), kw["alpha"], kw["max_seq_len"], kw["cfg"])
    fused, split = run_backward(bwd_args(t, kw, g), False), run_backward(bwd_args(t, kw, g), True)
    t16 = to_bf16(t)
    g16 = grad_of(t16)
    out16 = rab.hstu_attention_rab(*(t16[n] for n in NAMES), kw["alpha"], kw["max_seq_len"], kw["cfg"])
    fused16, split16 = run_backward(bwd_args(t16, kw, g16), False), run_backward(bwd_args(t16, kw, g16), True)
    torch.cuda.synchronize()
    for x in (out, out16, *fused, *split, *fused16, *split16):
        assert torch.isfinite(x.float()).all()
    if l == 4096:
        torch.testing.assert_close(out, rab.dense_forward(*(t[n] for n in NAMES), kw["alpha"], kw["max_seq_len"], kw["cfg"], True), rtol=RTOL, atol=ATOL)
        ref = rab.dense_backward(*bwd_args(t, kw, g), True)
        assert_grads_close(fused, ref)
        assert_grads_close(split, ref)


def table_grads_twice(t, kw, g, fused):
    runs = []
    for _ in range(2):
        got = rab.rab_backward_fused(*bwd_args(t, kw, g)) if fused else rab.rab_backward_dq(*bwd_args(t, kw, g))
        runs.append(tuple(x.clone() for x in got))
    torch.cuda.synchronize()
    return runs


# (B, H, L, d, buckets) and the dts tables the tensor-core K2 and K2a take there (0: the width-tiled variant)
TABLE_SHAPES = {"serving": ((8, 8, 256, 32, 128), 32), "L1024": ((2, 2, 1024, 64, 128), 32), "wide": ((2, 2, 200, 256, 128), 0),
                "a table a warp": ((2, 2, 300, 64, 2_000), 8), "one table in turns": ((2, 2, 300, 64, 6_000), 1)}


@pytest.mark.parametrize("fused", [True, False], ids=["K2", "K2a"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", list(TABLE_SHAPES))
def test_table_gradients_twice_agree_bit_for_bit(card, shape, dtype, fused):
    """dpos and dts of K2 and K2a: per-warp sums added in warp order (or one table the warps add to in turns), the
    CTAs' slices in CTA order, no float atomics; two launches agree bit for bit (K2a's dq too)."""
    (b, h, l, d, nb), tables = TABLE_SHAPES[shape]
    name = ("hstu_rab_bwd" if fused else "hstu_rab_bwd_dq") + ("_bf16" if dtype == torch.bfloat16 else "")
    assert rab.dts_tables(name, l, d, d, max(l, 256), nb) == tables
    t, kw = rab_inputs(card, b=b, h=h, l=l, maxl=max(l, 256), d=d, dv=d, nb=nb, times="shuffled" if nb > 128 else "sorted", mask="suffix")
    g = torch.from_numpy(np.random.default_rng(12).normal(size=t["v"].shape).astype(np.float32)).to(card)
    if dtype == torch.bfloat16:
        t, g = to_bf16(t), g.to(torch.bfloat16)
    first, second = table_grads_twice(t, kw, g, fused)
    names = ("dq", "dk", "dv", "dpos", "dts") if fused else ("dq", "dpos", "dts")
    for name, a, b_ in zip(names, first, second):
        if name == "dq" and fused:
            continue  # K2's dq: fp32 reductions in an order that changes from run to run
        assert torch.equal(a, b_), name


def test_split_training_is_deterministic_under_deterministic_algorithms(card):
    """Four steps of the HSTU through the split pair, twice from one seed under
    ``torch.use_deterministic_algorithms(True)``: the same parameters bit for bit."""
    from torch_rechub_tpu_torch.models.generative import HSTUModel

    def run():
        torch.manual_seed(0)
        model = HSTUModel(vocab_size=500, d_model=64, n_heads=2, n_layers=2, dqk=32, dv=32, max_seq_len=64, num_time_buckets=32, dropout=0.0,
                          generator=torch.Generator().manual_seed(3), device=card)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        gen = np.random.default_rng(5)
        for _ in range(4):
            ids = torch.from_numpy(gen.integers(1, 500, (4, 64))).to(card)
            ts = torch.from_numpy(np.sort(gen.integers(0, 10**7, (4, 64)), axis=1).astype(np.int32)).to(card)
            logits = model(ids, ts)
            loss = torch.nn.functional.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]).float(), ids[:, 1:].reshape(-1))
            opt.zero_grad()
            loss.backward()
            opt.step()
        torch.cuda.synchronize()
        return {n: p.detach().clone() for n, p in model.named_parameters()}

    counts = (rab.launches_bwd, rab.launches_bwd_dq)
    prior = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"  # cuBLAS's deterministic workspace, which the setting requires
    torch.use_deterministic_algorithms(True)
    try:
        first, second = run(), run()
    finally:
        torch.use_deterministic_algorithms(False)
        if prior is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prior
    assert rab.launches_bwd == counts[0] and rab.launches_bwd_dq > counts[1]  # the split pair, never K2
    for name in first:
        assert torch.equal(first[name], second[name]), name
