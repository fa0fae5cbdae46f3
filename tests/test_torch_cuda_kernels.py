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
    "wide_1024_d128": dict(b=1, h=2, l=1024, maxl=1024, d=128, dv=128, nb=128),
    # around the tile edges of K1 and K2a (32 q rows, 16 and 64 keys) and K2 and K2b (32 keys,
    # 16 and 64 queries), with widths that fill neither the 8-wide fragments nor the 16-byte copies evenly
    **{f"edge_{l}_dqk12_dv20": dict(l=l, d=12, dv=20, times="shuffled", mask="scattered", seed=l) for l in (15, 16, 17, 63, 65, 129, 255)},
    # widths that are not a multiple of 4: 4-byte copies and scalar dq atomics
    "odd_widths_dqk7_dv5": dict(l=50, d=7, dv=5, times="shuffled", mask="scattered"),
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


@pytest.mark.parametrize("l", [40, 130])
def test_kernel_matches_plain_on_wide_heads(card, l):
    """dqk 256, dv 128: too wide for two 64-key stages, so K1 stages 32 keys at a time."""
    t, kw = rab_inputs(card, l=l, d=256, dv=128, times="shuffled", mask="scattered")
    out = rab.hstu_attention_rab(t["q"], t["k"], t["v"], t["pos_w"], t["ts_w"], t["timestamps"], t["padding_mask"], kw["alpha"], kw["max_seq_len"], kw["cfg"])
    ref = rab.dense_forward(t["q"], t["k"], t["v"], t["pos_w"], t["ts_w"], t["timestamps"], t["padding_mask"], kw["alpha"], kw["max_seq_len"], kw["cfg"], True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)


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


def run_backward(args, split):
    """``(dq, dk, dv, dpos, dts)`` from K2, or from K2a then K2b."""
    if not split:
        return rab.rab_backward_fused(*args)
    dq, dpos, dts = rab.rab_backward_dq(*args)
    dk, dv = rab.rab_backward_dkv(*args)
    return dq, dk, dv, dpos, dts


SPLIT = pytest.mark.parametrize("split", [False, True], ids=["K2", "K2a+K2b"])


@SPLIT
@pytest.mark.parametrize("case", list(CASES))
def test_backward_kernels_match_plain(card, case, split):
    t, kw = rab_inputs(card, **CASES[case])
    g = torch.from_numpy(np.random.default_rng(7).normal(size=t["v"].shape).astype(np.float32)).to(card)
    args = bwd_args(t, kw, g)
    counts = (rab.launches_bwd, rab.launches_bwd_dq, rab.launches_bwd_dkv)
    got = run_backward(args, split)
    torch.cuda.synchronize()
    assert (rab.launches_bwd, rab.launches_bwd_dq, rab.launches_bwd_dkv) == (counts[0] + (not split), counts[1] + split, counts[2] + split)
    ref = rab.dense_backward(*args, t["timestamps"] is not None)
    assert_grads_close(got, ref)
    if case == "empty_row":
        assert torch.all(got[0][0] == 0) and all(torch.isfinite(x).all() for x in got)


@SPLIT
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


# The exact bucket lookup of K1, K2, K2a and K2b on rab.bucket_sweep_stamps: |t_l - t_m|
# hits every reachable threshold -1, 0 and +1 (row 0), and wrapping int32
# stamps reach |dt| = 2**31 (row 1).  The reference is the plain version on
# the CPU, where the thresholds were computed (the card's log may round an
# edge differently).
def sweep_inputs(cfg, h=2, d=16, seed=0):
    ts = rab.bucket_sweep_stamps(cfg, seed)
    l = ts.shape[1]
    rng = np.random.default_rng(seed)
    arr = {
        "q": rng.normal(size=(2, h, l, d)) * 0.1,
        "k": rng.normal(size=(2, h, l, d)) * 0.1,
        "v": rng.normal(size=(2, h, l, d)) * 0.3,
        "pos_w": rng.normal(size=(2 * l - 1, h)) * 0.1,
        "ts_w": rng.normal(size=(cfg.num_buckets + 1, h)),  # large: one bucket off moves the output
    }
    t = {k: torch.from_numpy(a.astype(np.float32)) for k, a in arr.items()}
    t.update(timestamps=ts, padding_mask=torch.ones((2, l), dtype=torch.bool))
    return t, dict(alpha=1.0 / math.sqrt(d), max_seq_len=l, cfg=cfg)


@SPLIT
@pytest.mark.parametrize("cfg", rab.SWEEP_CFGS, ids=lambda c: str(tuple(c)))
def test_bucket_sweep_matches_plain(card, cfg, split):
    t, kw = sweep_inputs(cfg)
    names = ("q", "k", "v", "pos_w", "ts_w", "timestamps", "padding_mask")
    dev = {n: t[n].to(card) for n in names}
    g = torch.from_numpy(np.random.default_rng(3).normal(size=t["v"].shape).astype(np.float32))
    out = rab.hstu_attention_rab(*(dev[n] for n in names), kw["alpha"], kw["max_seq_len"], kw["cfg"])
    grads = run_backward((*(dev[n] for n in names[:3]), g.to(card), *(dev[n] for n in names[3:]), kw["alpha"], kw["max_seq_len"], kw["cfg"]), split)
    torch.cuda.synchronize()
    ref = rab.dense_forward(*(t[n] for n in names), kw["alpha"], kw["max_seq_len"], kw["cfg"], True)
    torch.testing.assert_close(out.cpu(), ref, rtol=RTOL, atol=ATOL)
    ref_grads = rab.dense_backward(*(t[n] for n in names[:3]), g, *(t[n] for n in names[3:]), kw["alpha"], kw["max_seq_len"], kw["cfg"], True)
    assert_grads_close([x.cpu() for x in grads], ref_grads)


def first_design_max_l(width, nb):
    """The largest L whose shared memory the first K2 design (fp32 FMAs over
    64 x 64 tiles, dq/dk/dv columns of 16, 32, 64 or 128) fitted in 227 KB."""
    dw = next(w for w in (16, 32, 64, 128) if width <= w)
    words = 232448 // 4 - (4 * dw * 65 + 2 * 64 * 65 + 3 * (nb + 1) + 3 * 64)
    return words // 2  # L words of position bias and L of its gradient


# The layouts there (ring stages, dts copies), K2 and K2a alike: (2, 32) at d32 and d64,
# (1, 32) at d128; with 2000 buckets (2, 1) at d32 and (1, 1) at d128.  K2b (no dts
# copies) keeps two Q/G stages at all of them.
@SPLIT
@pytest.mark.parametrize("width,nb", [(32, 16), (64, 16), (128, 16), (32, 2000), (128, 2000)], ids=lambda x: str(x))
def test_kernels_take_the_longest_l_of_the_first_designs(card, width, nb, split):
    """K1 and the backward kernels take every L the first designs took: no new rejection at long sequences."""
    l = first_design_max_l(width, nb)
    t, kw = rab_inputs(card, b=1, h=1, l=l, maxl=l, d=width, dv=width, nb=nb, times="shuffled", mask="scattered", seed=width)
    names = ("q", "k", "v", "pos_w", "ts_w", "timestamps", "padding_mask")
    out = rab.hstu_attention_rab(*(t[n] for n in names), kw["alpha"], kw["max_seq_len"], kw["cfg"])
    g = torch.from_numpy(np.random.default_rng(13).normal(size=t["v"].shape).astype(np.float32)).to(card)
    got = run_backward(bwd_args(t, kw, g), split)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, rab.dense_forward(*(t[n] for n in names), kw["alpha"], kw["max_seq_len"], kw["cfg"], True), rtol=RTOL, atol=ATOL)
    del out
    assert_grads_close(got, rab.dense_backward(*bwd_args(t, kw, g), True))


@SPLIT
@pytest.mark.parametrize("l", [131, 130])
def test_kernels_read_a_mask_at_any_byte_offset(card, l, split):
    """A contiguous mask view that starts inside a 4-byte word (mask[1:] with L % 4 != 0)."""
    t, kw = rab_inputs(card, l=l, times="shuffled", mask="scattered")
    full = torch.ones((t["padding_mask"].shape[0] + 1, l), dtype=torch.bool, device=card)
    full[1:] = t["padding_mask"]
    t["padding_mask"] = full[1:]
    assert t["padding_mask"].is_contiguous() and t["padding_mask"].data_ptr() % 4 != 0
    names = ("q", "k", "v", "pos_w", "ts_w", "timestamps", "padding_mask")
    out = rab.hstu_attention_rab(*(t[n] for n in names), kw["alpha"], kw["max_seq_len"], kw["cfg"])
    g = torch.from_numpy(np.random.default_rng(14).normal(size=t["v"].shape).astype(np.float32)).to(card)
    got = run_backward(bwd_args(t, kw, g), split)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, rab.dense_forward(*(t[n] for n in names), kw["alpha"], kw["max_seq_len"], kw["cfg"], True), rtol=RTOL, atol=ATOL)
    assert_grads_close(got, rab.dense_backward(*bwd_args(t, kw, g), True))


def test_fused_backward_twice_agrees(card):
    """K2's dq, dpos and dts are sums of atomics whose order changes between runs: two runs agree within the tolerances."""
    t, kw = rab_inputs(card, b=4, times="shuffled", mask="scattered")
    g = torch.from_numpy(np.random.default_rng(12).normal(size=t["v"].shape).astype(np.float32)).to(card)
    first, second = (rab.rab_backward_fused(*bwd_args(t, kw, g)) for _ in range(2))
    torch.cuda.synchronize()
    assert_grads_close(first, second)
    torch.testing.assert_close(first[1], second[1], rtol=0, atol=0)  # dk, dv: a fixed order of sums
    torch.testing.assert_close(first[2], second[2], rtol=0, atol=0)


def test_split_backward_twice_agrees(card):
    """K2a's dq and K2b's dk, dv are sums in a fixed order: equal bit for bit between two runs;
    dpos and dts are sums of atomics and agree within the tolerances."""
    t, kw = rab_inputs(card, b=4, times="shuffled", mask="scattered")
    g = torch.from_numpy(np.random.default_rng(12).normal(size=t["v"].shape).astype(np.float32)).to(card)
    first, second = (run_backward(bwd_args(t, kw, g), split=True) for _ in range(2))
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=lambda m: f"{name}: {m}")
    assert_grads_close(first, second)


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
# Around its 32-row q tiles and 64-key (or, at dqk 256 with dv 128, 32-key)
# stages, its 16-byte and 4-byte bias copies (L % 4, the bias's alignment)
# and the mask words it finds by address.
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
    "ragged_203": dict(l=203, mask="scattered"),
    **{f"mask_at_byte_offset_{l}": dict(l=l, mask="scattered", mask_offset=True) for l in (131, 130)},
    "bias_at_4_byte_offset": dict(shared=True, mask="scattered", bias_offset=True),
    "bias_at_4_byte_offset_per_batch_ragged_77": dict(l=77, bias_offset=True),
    "dqk256_dv128_1024": dict(b=1, l=1024, d=256, dv=128, mask="scattered"),
    "dqk7_dv5_ragged_50": dict(l=50, d=7, dv=5, mask="scattered"),
}


def bias_inputs(device, b=2, h=3, l=256, d=32, dv=32, seed=0, mask="suffix", shared=False, nan=False, mask_offset=False, bias_offset=False):
    """``mask_offset``: the mask a contiguous view that starts inside a 4-byte word (``mask[1:]`` of a
    (B+1, L) buffer, L % 4 != 0); ``bias_offset``: the bias a contiguous view 4 bytes into a larger buffer."""
    t, _ = rab_inputs(device, b=b, h=h, l=l, maxl=l, d=d, dv=dv, seed=seed, times=None, mask=mask)
    rng = np.random.default_rng(seed + 100)
    bias = torch.from_numpy((rng.normal(size=(1 if shared else b, h, l, l)) * 0.1).astype(np.float32)).to(device)
    if nan:  # NaN where no valid pair reads: the upper triangle and the masked keys
        bias.masked_fill_(~torch.tril(torch.ones((l, l), dtype=torch.bool, device=device)), float("nan"))
        bias.masked_fill_(~t["padding_mask"][:, None, None, :], float("nan"))
    if mask_offset:
        full = torch.ones((b + 1, l), dtype=torch.bool, device=device)
        full[1:] = t["padding_mask"]
        t["padding_mask"] = full[1:]
        assert t["padding_mask"].is_contiguous() and t["padding_mask"].data_ptr() % 4 != 0
    if bias_offset:
        buf = torch.full((bias.numel() + 1,), float("nan"), device=device)
        buf[1:] = bias.flatten()
        bias = buf[1:].view(bias.shape)
        assert bias.is_contiguous() and bias.data_ptr() % 16 == 4
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


@pytest.mark.parametrize("shared", [False, True], ids=["per_batch", "shared"])
def test_attention_kernel_twice_agrees(card, shared):
    """K3 sums its key splits in a fixed order and uses no atomics: two runs agree bit for bit."""
    q, k, v, bias, mask, alpha, n = bias_inputs(card, b=4, mask="scattered", shared=shared)
    first, second = (attn.hstu_attention(q, k, v, bias, mask, alpha, n) for _ in range(2))
    torch.cuda.synchronize()
    torch.testing.assert_close(first, second, rtol=0, atol=0)


def test_attention_kernel_occupancy(card):
    """64-key stages at dqk = dv = 32 and 3 CTAs per SM; 32-key stages at dqk 256 with dv 128, which still fit."""
    ctas, regs, smem = attn.occupancy(256, 32, 32)
    assert ctas >= 3 and 0 < regs <= 85 and smem == attn.occupancy(4096, 32, 32)[2]  # shared memory does not grow with L
    ctas, regs, smem = attn.occupancy(1024, 256, 128)
    assert ctas >= 1 and smem <= 232448


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
