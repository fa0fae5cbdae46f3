#!/usr/bin/env python3
"""Drive the PyTorch port (``torch_rechub_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

1. Card: its name and power limit; fails without a CUDA device.
2. Build: every CUDA source of the port, with nvcc, from this checkout;
   the build log (ptxas's registers per kernel), and the CTAs per SM,
   registers and shared memory of K1, K2, K2a and K2b.
3. Kernels: each kernel against its plain PyTorch version on the card, at the
   serving shape and at adversarial ones, with a stated tolerance, and timed
   beside its bound (for the rab kernels K1, K2, K2a, K2b both the fp32-FMA
   and the 3xTF32 tensor-core bound): the forward K1, then the backward K2
   and K2a + K2b against the plain backward, on all five gradients; the
   bucket sweep (K1, K2 and K2a + K2b at every time-bucket threshold); then K3 through the
   op ``hstu_attention`` (materialised bias) on seven cases, against K1 on
   the serving model's own rab, and the op's gradients; its launch count.
4. Serving: the full-width HSTU model of ``benchmarks/perf/hstu_train_bench.py``
   (V40000, d256, 8 heads, 4 layers, L256, batch 8) with random weights from a
   seed, through ``SeqTrainer.evaluate`` / ``predict_logits``, dense and
   chunked; the kernels' launch counts over that run; the fused model's
   logits against the same weights without the kernel.
5. Training: the same configuration through ``SeqTrainer.train_one_epoch``,
   chunked 8192 (the bench's path) and dense, on seeded bench-style data;
   tokens/s, ms per step, and where a step's time goes; the loss finite and
   every parameter moved; K1 and K2 launched once per layer per step, and
   one step with ``_FUSED_BWD[0] = False`` through K2a and K2b; the layers'
   backward timed through K2 and through K2a + K2b; one batch's parameter
   gradients against the same weights without the kernels.
6. One JSON line of kernels, then the last line ``{"ok": true, "device": ...}``.

Any failure raises, so the exit code is not 0 and the last line is not printed.
Float32 throughout, TF32 off.
"""

from __future__ import annotations

import gc
import importlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_rechub_tpu_torch.models.generative import HSTUModel  # noqa: E402
from torch_rechub_tpu_torch.ops.cuda import _build, hstu_attention  # noqa: E402
from torch_rechub_tpu_torch.ops.cuda import hstu_rab_attention as rab  # noqa: E402
from torch_rechub_tpu_torch.trainers.seq_trainer import SeqTrainer  # noqa: E402
from torch_rechub_tpu_torch.utils.data import SeqLoader  # noqa: E402
from torch_rechub_tpu_torch.utils.hstu_utils import RelativeBucketedTimeAndPositionBias  # noqa: E402

# the module of the op K3: the package binds the name hstu_attention to the op itself
attn = importlib.import_module("torch_rechub_tpu_torch.ops.cuda.hstu_attention")

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor cores,
# dense TF32 on the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_HBM_BYTES = 3.35e12
TF32_PASSES = 3  # the rab kernels run every product as 3xTF32: hi*hi + hi*lo + lo*hi
TENSOR_CORE_KERNELS = ("hstu_rab_fwd", "hstu_rab_bwd", "hstu_rab_bwd_dq", "hstu_rab_bwd_dkv")
# kernel vs plain version: fp32 sums of up to L products in another order than cuBLAS
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
# backward kernels vs the plain backward: dq, dk, dv as the forward (K2's dq
# adds per-tile fp32 atomics, in an order that changes between runs); dpos
# and dts sum up to B*L^2/2 terms of either sign into one slot, in another
# order than autograd's scatter-add, so their absolute tolerance is relative
# to the table's largest slot
BWD_RTOL, BWD_ATOL = 1e-4, 1e-5
TABLE_RTOL, TABLE_ATOL_REL = 1e-4, 1e-5
# fused vs unfused model logits: the kernel's error carried through 4 layers and the vocab projection
LOGIT_RTOL, LOGIT_ATOL = 1e-4, 1e-4
# fused vs unfused parameter gradients of one batch: the backward's error
# carried back through 4 layers; elements near zero are sums that cancel, so
# the absolute tolerance is relative to each tensor's largest gradient
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-4
SERVE = dict(vocab_size=40000, d_model=256, n_heads=8, n_layers=4, dqk=32, dv=32, max_seq_len=256, num_time_buckets=128, time_bucket_fn="sqrt", time_bucket_unit="minutes", tie_embeddings=True, dropout=0.0)
BATCH, N_BATCHES = 8, 4
TRAIN_BATCHES = 6  # steps per timed training epoch
REPS = 30
GRAD_NAMES = ("dq", "dk", "dv", "dpos", "dts")
# the backward kernels: wrapper, outputs, FMAs per causal pair per unit of (dqk, dv), TPU kernel line
BWD_KERNELS = {
    "hstu_rab_bwd": dict(fn=rab.rab_backward_fused, outs=GRAD_NAMES, fma=(3, 2), line=459),
    "hstu_rab_bwd_dq": dict(fn=rab.rab_backward_dq, outs=("dq", "dpos", "dts"), fma=(2, 1), line=313),
    "hstu_rab_bwd_dkv": dict(fn=rab.rab_backward_dkv, outs=("dk", "dv"), fma=(2, 2), line=404),
}
COUNTERS = {"hstu_rab_fwd": "launches", "hstu_rab_bwd": "launches_bwd", "hstu_rab_bwd_dq": "launches_bwd_dq", "hstu_rab_bwd_dkv": "launches_bwd_dkv"}


def reset_counts():
    for attr in COUNTERS.values():
        setattr(rab, attr, 0)


def read_counts():
    return {name: getattr(rab, attr) for name, attr in COUNTERS.items()}


def spin_cycles_per_ms():
    """Device clock cycles per ms of ``torch.cuda._sleep``, its spin wait."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(2):  # the first call pays for loading the spin kernel
        start.record()
        torch.cuda._sleep(10**7)
        end.record()
        end.synchronize()
    return 10**7 / start.elapsed_time(end)


def timed(fn, cycles_per_ms, reps=REPS, warmup=3):
    """(device ms, host-clock ms) of one call of ``fn``, each the median of ``reps``.

    Host clock: one call ended by a synchronise, what a caller waits for.
    Device time: CUDA events around one call that was enqueued while the
    device ran a spin wait longer than the enqueueing, so the events see the
    call's device work back to back and not the host's launch cost.  A call
    whose enqueueing outlasted the wait (a host stall: another process, the
    scheduler) is measured again behind a spin twice as long as it took;
    more such repeats than ``reps`` in all raise.  The garbage collector is
    off while the calls are timed.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    gc.collect()
    gc.disable()
    try:
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        spin_ms = 3 * max(walls) + 1.0  # 1 ms of margin: a host hiccup must not outlast the wait
        times, repeats, stall_ms = [], 0, 0.0
        while len(times) < reps:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            torch.cuda._sleep(int(spin_ms * cycles_per_ms))
            ev[1].record()
            t0 = time.perf_counter()
            fn()
            enqueue_ms = (time.perf_counter() - t0) * 1e3
            ev[2].record()
            ev[2].synchronize()
            if enqueue_ms < ev[0].elapsed_time(ev[1]):
                times.append(ev[1].elapsed_time(ev[2]))
                continue
            repeats, stall_ms = repeats + 1, max(stall_ms, enqueue_ms)
            if repeats > reps:
                raise AssertionError(f"the host enqueued for longer than the device waited in {repeats} calls (the last {enqueue_ms:.1f} ms): the device time would count host time")
            spin_ms = max(spin_ms, 2 * enqueue_ms + 1.0)
    finally:
        gc.enable()
    if repeats:
        print(f"    ({repeats} of {reps + repeats} timed calls were measured again: the host stalled while enqueueing, up to {stall_ms:.1f} ms)")
    return float(np.median(times)), float(np.median(walls))


# ---------------------------------------------------------------------------
# 3. kernel phase
# ---------------------------------------------------------------------------

def rab_case(seed, b, l, max_seq_len, times="sorted", mask="suffix", h=8, d=32, nb=128):
    rng = np.random.default_rng(seed)
    arr = {
        "q": (rng.normal(size=(b, h, l, d)) * 0.3).astype(np.float32),
        "k": (rng.normal(size=(b, h, l, d)) * 0.3).astype(np.float32),
        "v": (rng.normal(size=(b, h, l, d)) * 0.3).astype(np.float32),
        "pos_w": (rng.normal(size=(2 * max_seq_len - 1, h)) * 0.1).astype(np.float32),
        "ts_w": (rng.normal(size=(nb + 1, h)) * 0.1).astype(np.float32),
        "ts": None,
        "mask": None,
    }
    if times == "sorted":
        arr["ts"] = np.sort(rng.integers(0, 10**6, (b, l)), axis=1).astype(np.int32)
    elif times == "shuffled":
        arr["ts"] = rng.integers(0, 3_000_000, (b, l)).astype(np.int32)
    elif times == "wrapping":  # both ends of int32: the int32 differences wrap to small values
        near = rng.integers(0, 20_000, (b, l))
        arr["ts"] = np.where(rng.uniform(size=(b, l)) < 0.5, 2**31 - 1 - near, -(2**31) + near).astype(np.int32)
    if mask == "suffix":
        arr["mask"] = np.arange(l)[None, :] < rng.integers(l // 2, l + 1, (b, 1))
    elif mask == "scattered":
        arr["mask"] = rng.uniform(size=(b, l)) > 0.3
        arr["mask"][0, :] = False  # one fully masked row
    case = {k: None if a is None else torch.from_numpy(a).cuda() for k, a in arr.items()}
    cfg = rab.BucketCfg(num_buckets=nb, fn="sqrt", divisor=1.0, unit="minutes")
    case.update(cfg=cfg, thr=rab.compute_bucket_thresholds(cfg).cuda(), max_seq_len=max_seq_len, alpha=1.0 / math.sqrt(d))
    return case


def run_kernel(c):
    return rab.hstu_attention_rab(c["q"], c["k"], c["v"], c["pos_w"], c["ts_w"], c["ts"], c["mask"], c["alpha"], c["max_seq_len"], c["cfg"], c["thr"])


def run_plain(c):
    return rab.dense_forward(c["q"], c["k"], c["v"], c["pos_w"], c["ts_w"], c["ts"], c["mask"], c["alpha"], c["max_seq_len"], c["cfg"], c["ts"] is not None)


def valid_pairs(c):
    """(query, key) pairs this run's data needs: m <= l < L with key m unmasked, over all heads."""
    b, h, l, _ = c["q"].shape
    keys = torch.ones((b, l), dtype=torch.int64, device=c["q"].device) if c["mask"] is None else c["mask"].to(torch.int64)
    return h * int(keys.cumsum(1).sum())


def bound(flops, nbytes, peak=PEAK_FP32_FLOPS):
    """(bound ms, what bounds it): FLOPs at the peak of the units that run them vs bytes at the HBM rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def both_bounds(kernel, flops, nbytes):
    """{"fp32": (ms, by), "tensor": (ms, by) or None, "bound_ms", "bound_by"}: the fp32-FMA bound, and
    for the tensor-core kernels the 3xTF32 bound, which is then the least time and the reported one."""
    fp32 = bound(flops, nbytes)
    tensor = bound(TF32_PASSES * flops, nbytes, PEAK_TF32_FLOPS) if kernel in TENSOR_CORE_KERNELS else None
    least = tensor or fp32
    return dict(fp32=fp32, tensor=tensor, bound_ms=least[0], bound_by=least[1])


def bounds_text(b):
    text = f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})"
    if b["tensor"] is not None:
        text += f"; fp32-FMA bound {b['fp32'][0]:.4f} ms ({b['fp32'][1]}), 3xTF32 tensor-core bound {b['tensor'][0]:.4f} ms ({b['tensor'][1]})"
    return text


def input_bytes(c):
    return sum(t.numel() * t.element_size() for t in c.values() if isinstance(t, torch.Tensor))


def rab_bound(c):
    """K1: 2 (dqk + dv) FLOP per valid pair; inputs read and the output written once."""
    dqk, dv = c["q"].shape[-1], c["v"].shape[-1]
    return both_bounds("hstu_rab_fwd", 2 * valid_pairs(c) * (dqk + dv), input_bytes(c) + c["v"].numel() * 4)


def bwd_bound(c, g, kernel, outs):
    """A backward kernel: its FMAs per valid pair; inputs and g read, its outputs written once."""
    fq, fv = BWD_KERNELS[kernel]["fma"]
    dqk, dv = c["q"].shape[-1], c["v"].shape[-1]
    return both_bounds(kernel, 2 * valid_pairs(c) * (fq * dqk + fv * dv), input_bytes(c) + g.numel() * 4 + sum(o.numel() * 4 for o in outs))


def kernel_cases():
    return {
        "serve B8 L256 sorted times, suffix padding": rab_case(0, 8, 256, 256),
        "B8 L256 shuffled times, scattered mask, one empty row": rab_case(1, 8, 256, 256, times="shuffled", mask="scattered"),
        "B8 L256 stamps at both ends of int32 (wrapping differences)": rab_case(5, 8, 256, 256, times="wrapping"),
        "B8 L256 no times, mask None": rab_case(2, 8, 256, 256, times=None, mask=None),
        "B8 L200 ragged, maxL256": rab_case(3, 8, 200, 256),
        "B8 L1024 maxL1024": rab_case(4, 8, 1024, 1024),
    }


def sweep_case(cfg, h=8, d=32, seed=30):
    """CPU tensors on ``rab.bucket_sweep_stamps``: |t_l - t_m| hits every reachable threshold
    -1, 0 and +1 (row 0), and wrapping stamps reach |dt| = 2**31 (row 1)."""
    ts = rab.bucket_sweep_stamps(cfg, seed)
    l = ts.shape[1]
    rng = np.random.default_rng(seed)
    arr = {"q": rng.normal(size=(2, h, l, d)) * 0.1, "k": rng.normal(size=(2, h, l, d)) * 0.1, "v": rng.normal(size=(2, h, l, d)) * 0.3,
           "pos_w": rng.normal(size=(2 * l - 1, h)) * 0.1, "ts_w": rng.normal(size=(cfg.num_buckets + 1, h))}  # large ts_w: a bucket off shows
    case = {k: torch.from_numpy(a.astype(np.float32)) for k, a in arr.items()}
    case.update(ts=ts, mask=torch.ones((2, l), dtype=torch.bool), cfg=cfg, thr=rab.compute_bucket_thresholds(cfg), max_seq_len=l, alpha=1.0 / math.sqrt(d))
    return case


def sweep_phase():
    """K1, K2 and K2a + K2b on the bucket sweep of every config, against the plain version on the CPU
    (where the thresholds were computed: the card's log may round an edge differently).  Max abs errs."""
    worst = {"hstu_rab_fwd": 0.0, **{kernel: 0.0 for kernel in BWD_KERNELS}}
    for cfg in rab.SWEEP_CFGS:
        c = sweep_case(cfg)
        g = torch.from_numpy(np.random.default_rng(31).normal(size=tuple(c["v"].shape)).astype(np.float32))
        dev = {k: v.cuda() if isinstance(v, torch.Tensor) else v for k, v in c.items()}
        out = run_kernel(dev).cpu()
        args = (c["q"], c["k"], c["v"], g, c["pos_w"], c["ts_w"], c["ts"], c["mask"], c["alpha"], c["max_seq_len"], c["cfg"])
        dev_args = [a.cuda() if isinstance(a, torch.Tensor) else a for a in args] + [dev["thr"]]
        ref, ref_grads = run_plain(c), dict(zip(GRAD_NAMES, rab.dense_backward(*args, True)))
        err, ratio = check_close(f"hstu_rab_fwd on the bucket sweep {cfg}", out, ref, KERNEL_RTOL, KERNEL_ATOL)
        worst["hstu_rab_fwd"] = max(worst["hstu_rab_fwd"], err)
        parts = [f"out {err:.2e} ({ratio:.3f})"]
        for kernel, spec in BWD_KERNELS.items():
            for name, a in zip(spec["outs"], spec["fn"](*dev_args)):
                r = ref_grads[name]
                rtol, atol = (TABLE_RTOL, TABLE_ATOL_REL * float(r.abs().max()) + 1e-12) if name in ("dpos", "dts") else (BWD_RTOL, BWD_ATOL)
                err, ratio = check_close(f"{kernel}'s {name} on the bucket sweep {cfg}", a.cpu(), r, rtol, atol)
                worst[kernel] = max(worst[kernel], err)
                parts.append(f"{kernel} {name} {err:.2e} ({ratio:.3f})")
        print(f"  bucket sweep {tuple(cfg)}, L{c['max_seq_len']}, {len(c['thr'])} thresholds: max abs err (ratio) " + ", ".join(parts))
    return worst


def kernel_phase(cases, cycles_per_ms):
    worst = 0.0
    timings = {}
    for name, c in cases.items():
        out = run_kernel(c)
        ref = run_plain(c)
        torch.cuda.synchronize()
        diff = (out - ref).abs()
        err = float(diff.max())
        ratio = float((diff / (KERNEL_ATOL + KERNEL_RTOL * ref.abs())).max())
        print(f"  {name}: max abs err {err:.3e} (max |ref| {float(ref.abs().max()):.3e}), max |d|/(atol+rtol|ref|) {ratio:.3f} (rtol {KERNEL_RTOL}, atol {KERNEL_ATOL})")
        if not (torch.isfinite(out).all() and ratio <= 1.0):
            raise AssertionError(f"hstu_rab_fwd disagrees with its plain version on {name}")
        if c["mask"] is not None and not bool(c["mask"][0].any()) and not bool((out[0] == 0).all()):
            raise AssertionError("a fully masked row must give zeros")
        worst = max(worst, err)
        if name.startswith("serve") or "L1024" in name:
            (ms, wall), (plain_ms, plain_wall) = timed(lambda: run_kernel(c), cycles_per_ms), timed(lambda: run_plain(c), cycles_per_ms)
            b = rab_bound(c)
            timings[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b["bound_ms"], bound_by=b["bound_by"])
            print(f"    device time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, {bounds_text(b)}; "
                  f"host clock per call: kernel {wall:.4f} ms, plain {plain_wall:.4f} ms; medians of {REPS}")
    serve = timings[next(iter(timings))]
    return dict(max_abs_err=worst, **serve)


def backward_phase(cases, cycles_per_ms):
    """K2, and K2a + K2b, against the plain backward on every case, all five gradients."""
    worst = {name: 0.0 for name in BWD_KERNELS}
    timings = {}
    for case, c in cases.items():
        g = torch.from_numpy(np.random.default_rng(10).normal(size=tuple(c["v"].shape)).astype(np.float32)).cuda()
        args = (c["q"], c["k"], c["v"], g, c["pos_w"], c["ts_w"], c["ts"], c["mask"], c["alpha"], c["max_seq_len"], c["cfg"], c["thr"])
        ref = dict(zip(GRAD_NAMES, rab.dense_backward(*args[:-1], c["ts"] is not None)))
        empty_row = c["mask"] is not None and not bool(c["mask"][0].any())
        for kernel, spec in BWD_KERNELS.items():
            got = dict(zip(spec["outs"], spec["fn"](*args)))
            torch.cuda.synchronize()
            parts = []
            for o, t in got.items():
                r = ref[o]
                tables = o in ("dpos", "dts")
                rtol, atol = (TABLE_RTOL, TABLE_ATOL_REL * float(r.abs().max()) + 1e-12) if tables else (BWD_RTOL, BWD_ATOL)
                err = float((t - r).abs().max())
                ratio = float(((t - r).abs() / (atol + rtol * r.abs())).max())
                parts.append(f"{o} {err:.2e} ({ratio:.3f})")
                if not (torch.isfinite(t).all() and ratio <= 1.0):
                    raise AssertionError(f"{kernel} disagrees with the plain backward on {o}, {case}: max abs err {err:.3e}, ratio {ratio:.3f}")
                if empty_row and not tables and not bool((t[0] == 0).all()):
                    raise AssertionError(f"{kernel}: a fully masked row must give zero {o}")
                worst[kernel] = max(worst[kernel], err)
            print(f"  {case}, {kernel}: max abs err (max |d|/(atol+rtol|ref|)) " + ", ".join(parts))
            if case.startswith("serve") or "L1024" in case:
                ms, wall = timed(lambda: spec["fn"](*args), cycles_per_ms)
                b = bwd_bound(c, g, kernel, got.values())
                timings.setdefault(kernel, {})[case] = dict(ms=ms, bound_ms=b["bound_ms"], bound_by=b["bound_by"])
                print(f"    {kernel} device {ms:.4f} ms, {bounds_text(b)}, {valid_pairs(c):,} valid pairs; host clock per call {wall:.4f} ms")
        if case.startswith("serve") or "L1024" in case:
            plain_ms, plain_wall = timed(lambda: rab.dense_backward(*args[:-1], c["ts"] is not None), cycles_per_ms)
            for kernel in BWD_KERNELS:
                timings[kernel][case]["plain_ms"] = plain_ms
            print(f"    plain backward device {plain_ms:.4f} ms, host clock {plain_wall:.4f} ms (medians of {REPS})")
    print(f"  tolerances: dq/dk/dv rtol {BWD_RTOL} atol {BWD_ATOL}; dpos/dts rtol {TABLE_RTOL}, atol {TABLE_ATOL_REL} x the table's max |ref|")
    return {kernel: dict(max_abs_err=worst[kernel], **next(iter(timings[kernel].values()))) for kernel in BWD_KERNELS}


# ---------------------------------------------------------------------------
# 3b. the materialised-bias op hstu_attention (K3)
# ---------------------------------------------------------------------------

def bias_case(seed, b, l, max_seq_len, times="sorted", mask="suffix", shared=False, nan=False, h=8, d=32):
    """q, k, v and the bias that the serving HSTU's own rab module makes from seeded tables and stamps."""
    c = rab_case(seed, b, l, max_seq_len, times=times, mask=mask, h=h, d=d, nb=SERVE["num_time_buckets"])
    dev = c["q"].device
    module = RelativeBucketedTimeAndPositionBias(h, max_seq_len, SERVE["num_time_buckets"], SERVE["time_bucket_fn"], 1.0, SERVE["time_bucket_unit"],
                                                 generator=torch.Generator().manual_seed(seed), device=dev)
    with torch.no_grad():
        bias = module(seq_len=l) if shared else module(c["ts"])
        c["pos_w"], c["ts_w"] = (t.detach() for t in module.tables())
    bias = bias.contiguous()  # the module's output is a permuted view
    if nan:  # NaN where no valid pair reads: the upper triangle and the masked keys
        bias.masked_fill_(~torch.tril(torch.ones((l, l), dtype=torch.bool, device=dev)), float("nan"))
        bias.masked_fill_(~c["mask"][:, None, None, :], float("nan"))
    c.update(bias=bias, max_seq_len=float(max_seq_len))
    return c


def bias_cases():
    return {
        "(a) serve B8 L256, the model's own (B, H, L, L) rab, sorted stamps, suffix padding": bias_case(20, 8, 256, 256),
        "(b) B8 L256 shared (1, H, L, L) position-only bias": bias_case(21, 8, 256, 256, shared=True),
        "(c) B8 L256 shuffled stamps, scattered mask, one empty row": bias_case(22, 8, 256, 256, times="shuffled", mask="scattered"),
        "(d) B8 L200 ragged, maxL256": bias_case(23, 8, 200, 256),
        "(e) B8 L256 padding_mask None": bias_case(24, 8, 256, 256, mask=None),
        "(f) B8 L256 NaN in the bias's upper triangle and at masked keys": bias_case(20, 8, 256, 256, nan=True),
        "(g) B8 L1024 maxL1024": bias_case(25, 8, 1024, 1024),
    }


def run_op(c, bias=None):
    return hstu_attention(c["q"], c["k"], c["v"], c["bias"] if bias is None else bias, c["mask"], c["alpha"], c["max_seq_len"])


def run_op_plain(c, bias=None):
    return attn.dense_forward(c["q"], c["k"], c["v"], c["bias"] if bias is None else bias, c["mask"], c["alpha"], c["max_seq_len"])


def attn_bound(c):
    """K3: 2 (dqk + dv) FLOP per valid pair; q, k, v, the mask and the output
    moved once, and of the bias only the elements some valid pair reads."""
    b, h, l, dqk = c["q"].shape
    dv = c["v"].shape[-1]
    keys = torch.ones((b, l), dtype=torch.bool, device=c["q"].device) if c["mask"] is None else c["mask"]
    pairs = valid_pairs(c)
    bias_elems = pairs if c["bias"].shape[0] == b else h * int(keys.any(0).to(torch.int64).cumsum(0).sum())
    nbytes = 4 * (2 * c["q"].numel() + 2 * c["v"].numel()) + (0 if c["mask"] is None else keys.numel()) + 4 * bias_elems
    return bound(2 * pairs * (dqk + dv), nbytes)


def check_close(name, got, ref, rtol, atol):
    diff = (got - ref).abs()
    err, ratio = float(diff.max()), float((diff / (atol + rtol * ref.abs())).max())
    if not (torch.isfinite(got).all() and ratio <= 1.0):
        raise AssertionError(f"{name}: max abs err {err:.3e}, max |d|/(atol+rtol|ref|) {ratio:.3f}")
    return err, ratio


def attention_phase(cases, cycles_per_ms):
    """K3 through the op on every case against its plain version, against K1 on
    the model's own rab, and its gradients; the launch count of these op calls."""
    attn.launches = 0
    calls = 0
    worst = 0.0
    for name, c in cases.items():
        with torch.no_grad():
            out = run_op(c)
            calls += 1
            ref = run_op_plain(c)
        torch.cuda.synchronize()
        err, ratio = check_close(f"hstu_attn_fwd vs its plain version, {name}", out, ref, KERNEL_RTOL, KERNEL_ATOL)
        worst = max(worst, err)
        print(f"  {name}: max abs err {err:.3e} (max |ref| {float(ref.abs().max()):.3e}), max |d|/(atol+rtol|ref|) {ratio:.3f}")
        if c["mask"] is not None and not bool(c["mask"][0].any()) and not bool((out[0] == 0).all()):
            raise AssertionError("a fully masked row must give zeros")
        if name.startswith("(a)"):
            with torch.no_grad():
                k1 = rab.hstu_attention_rab(c["q"], c["k"], c["v"], c["pos_w"], c["ts_w"], c["ts"], c["mask"], c["alpha"], int(c["max_seq_len"]), c["cfg"], c["thr"])
            err, ratio = check_close("hstu_attn_fwd vs hstu_rab_fwd on the model's own rab", out, k1, KERNEL_RTOL, KERNEL_ATOL)
            print(f"    against K1 (hstu_attention_rab) on the same tables, stamps and mask: max abs err {err:.3e}, ratio {ratio:.3f}")
    print(f"  tolerance: rtol {KERNEL_RTOL}, atol {KERNEL_ATOL}")

    for name, c in cases.items():
        if not name.startswith(("(a)", "(b)")):
            continue
        g = torch.from_numpy(np.random.default_rng(11).normal(size=tuple(c["v"].shape)).astype(np.float32)).cuda()
        got, ref = ([t.detach().clone().requires_grad_(True) for t in (c["q"], c["k"], c["v"], c["bias"])] for _ in range(2))
        hstu_attention(*got, c["mask"], c["alpha"], c["max_seq_len"]).backward(g)
        calls += 1
        attn.dense_forward(*ref, c["mask"], c["alpha"], c["max_seq_len"]).backward(g)
        torch.cuda.synchronize()
        if got[3].grad.shape != c["bias"].shape:
            raise AssertionError(f"dbias has shape {tuple(got[3].grad.shape)}, the bias {tuple(c['bias'].shape)}")
        parts = []
        for gname, a, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
            err, ratio = check_close(f"hstu_attention's {gname} vs autograd of the plain version, {name}", a.grad, r.grad, BWD_RTOL, BWD_ATOL)
            parts.append(f"{gname} {err:.2e} ({ratio:.3f})")
        print(f"  backward through the op, {name}: dbias {tuple(got[3].grad.shape)}; max abs err (ratio) " + ", ".join(parts))

    launches = attn.launches
    print(f"  hstu_attn_fwd launches {launches} over {calls} op calls")
    if launches != calls:
        raise AssertionError(f"hstu_attention did not launch K3 once per call: {launches} launches, {calls} calls")

    timings = {}
    for name, c in cases.items():
        if not name.startswith(("(a)", "(b)", "(g)")):
            continue
        with torch.no_grad():
            (ms, wall), (plain_ms, plain_wall) = timed(lambda: run_op(c), cycles_per_ms), timed(lambda: run_op_plain(c), cycles_per_ms)
        bound_ms, bound_by = attn_bound(c)  # fp32 FMAs: K3 keeps the first design
        timings[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        print(f"  {name}: device time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, {valid_pairs(c):,} valid pairs); "
              f"host clock per call: kernel {wall:.4f} ms, plain {plain_wall:.4f} ms; medians of {REPS}")
    return dict(launches=launches, max_abs_err=worst, **timings[next(iter(timings))])


# ---------------------------------------------------------------------------
# 4. serving phase
# ---------------------------------------------------------------------------

def serving_data(n, l, vocab, seed=0, pad=True):
    """Sequences as in hstu_train_bench.py:50-55; with ``pad``, a left-padded PAD prefix on half the rows."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab, (n, l)).astype(np.int32)
    for i in range(0, n, 2) if pad else ():
        tokens[i, : rng.integers(1, l // 2)] = 0
    positions = np.broadcast_to(np.arange(l, dtype=np.int32), (n, l)).copy()
    time_diffs = np.sort(rng.integers(0, 10**6, (n, l)), axis=1).astype(np.int32)
    targets = rng.integers(1, vocab, n).astype(np.int32)
    return tokens, positions, targets, time_diffs


def serving_phase(cycles_per_ms):
    l, vocab, n_layers = SERVE["max_seq_len"], SERVE["vocab_size"], SERVE["n_layers"]
    model = HSTUModel(**SERVE, generator=torch.Generator().manual_seed(0), device="cuda")
    data = serving_data(BATCH * N_BATCHES, l, vocab)
    loader = SeqLoader(*data, batch_size=BATCH)
    trainers = {"dense": SeqTrainer(model), "chunked 8192": SeqTrainer(model, vocab_chunk_size=8192)}
    forwards = [0]
    model.register_forward_pre_hook(lambda module, args: forwards.__setitem__(0, forwards[0] + 1))

    for tr in trainers.values():  # warm-up: cuBLAS handles, allocator, library load
        tr.evaluate(loader)
    torch.cuda.synchronize()

    reset_counts()
    forwards[0] = 0
    results = {}
    for name, tr in trainers.items():
        t0 = time.perf_counter()
        loss, top1 = tr.evaluate(loader)
        t_eval = time.perf_counter() - t0
        t0 = time.perf_counter()
        logits = tr.predict_logits(loader)
        t_pred = time.perf_counter() - t0
        results[name] = dict(loss=loss, top1=top1, logits=logits, t_eval=t_eval, t_pred=t_pred)
    launches, n_forward = rab.launches, forwards[0]

    print(f"  hstu_rab_fwd launches {launches} over {n_forward} model forwards x {n_layers} layers")
    if n_forward != 2 * len(trainers) * N_BATCHES or launches != n_layers * n_forward:
        raise AssertionError(f"the serving path did not run the kernel once per layer: {launches} launches, {n_forward} forwards")
    tokens = BATCH * N_BATCHES * l
    for name, r in results.items():
        print(f"  {name}: eval loss {r['loss']:.6f}, top-1 {r['top1']:.4f}, {tokens / r['t_eval']:,.0f} tokens/s, "
              f"{r['t_eval'] / N_BATCHES * 1e3:.3f} ms per request of {BATCH} sequences; predict_logits {r['t_pred'] / N_BATCHES * 1e3:.3f} ms per request")
        if not (math.isfinite(r["loss"]) and 0 < r["loss"] < 2 * math.log(vocab)) or r["logits"].shape != (BATCH * N_BATCHES, vocab) or not np.isfinite(r["logits"]).all():
            raise AssertionError(f"serving output out of range ({name})")
    dense, chunked = results["dense"], results["chunked 8192"]
    if not math.isclose(dense["loss"], chunked["loss"], rel_tol=1e-5):
        raise AssertionError(f"dense and chunked eval losses differ: {dense['loss']} vs {chunked['loss']}")

    # the same weights without the kernel (materialised bias), one batch, last position
    plain = HSTUModel(**SERVE, use_fused_kernel=False, device="cuda")
    plain.load_state_dict(model.state_dict())
    toks, _, tds, _ = next(iter(loader))
    toks, tds = torch.from_numpy(toks).cuda(), torch.from_numpy(tds).cuda()
    with torch.inference_mode():
        fused_last, plain_last = model.eval()(toks, tds)[:, -1], plain.eval()(toks, tds)[:, -1]
    diff = (fused_last - plain_last).abs()
    ratio = float((diff / (LOGIT_ATOL + LOGIT_RTOL * plain_last.abs())).max())
    print(f"  fused vs unfused last-position logits: max abs err {float(diff.max()):.3e}, max |d|/(atol+rtol|ref|) {ratio:.3f} (rtol {LOGIT_RTOL}, atol {LOGIT_ATOL})")
    if ratio > 1.0:
        raise AssertionError("the fused model disagrees with the unfused one")

    # where a request's time goes: its stages on that batch, device time against
    # the host clock; the difference is the time the device waits for the host
    tgts = torch.from_numpy(next(iter(loader))[3]).cuda()
    with torch.inference_mode():
        stages = {
            f"embeddings + {n_layers} HSTU layers (hidden states)": lambda: model(toks, tds, return_hidden=True),
            "forward with (B, L, V) logits": lambda: model(toks, tds),
            "eval_step dense (forward + log-softmax CE + top-1)": lambda: trainers["dense"].eval_step(toks, tds, tgts),
            "eval_step chunked 8192": lambda: trainers["chunked 8192"].eval_step(toks, tds, tgts),
        }
        for name, fn in stages.items():
            device, wall = timed(fn, cycles_per_ms)
            print(f"  stage {name}: device {device:.4f} ms, host clock {wall:.4f} ms, device idle {1 - device / wall:.0%} (medians of {REPS})")
    return launches


def kernel_class(name):
    for key, label in (("hstu_rab_fwd_kernel", "K1 hstu_rab_fwd"), ("bwd_fused_kernel<", "K2 hstu_rab_bwd"), ("bwd_kv_kernel<", "K2b hstu_rab_bwd_dkv"), ("bwd_q_kernel<", "K2a hstu_rab_bwd_dq")):
        if key in name:
            return label
    lowered = name.lower()
    if "gemm" in lowered:
        return "matrix products (cuBLAS / CUTLASS, fp32)"
    if "multi_tensor_apply" in lowered or "adam" in lowered:
        return "Adam (foreach kernels)"
    if lowered.startswith("memcpy") or lowered.startswith("memset"):
        return "copies and fills"
    return "elementwise, reductions, gathers"


def kernel_breakdown(name, fn, steps=3):
    """Device time per call of ``fn`` by kernel class, from torch.profiler's kernel events."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    classes = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            ms, n = classes.get(kernel_class(e.key), (0.0, 0))
            classes[kernel_class(e.key)] = (ms + e.self_device_time_total / 1e3 / steps, n + e.count / steps)
    total = sum(ms for ms, _ in classes.values())
    if total <= 0:
        raise AssertionError("torch.profiler saw no device time")
    print(f"  {name} train_step kernels by class (torch.profiler, {steps} steps): {total:.4f} ms of kernels per step")
    for label, (ms, n) in sorted(classes.items(), key=lambda kv: -kv[1][0]):
        print(f"    {ms:.4f} ms {ms / total:6.1%} {n:6.1f} launches  {label}")


# ---------------------------------------------------------------------------
# 5. training phase
# ---------------------------------------------------------------------------

def training_phase(cycles_per_ms):
    l, vocab, n_layers = SERVE["max_seq_len"], SERVE["vocab_size"], SERVE["n_layers"]
    data = serving_data(BATCH * TRAIN_BATCHES, l, vocab, seed=1, pad=False)  # the bench's data: no PAD
    loader = SeqLoader(*data, batch_size=BATCH)
    first = SeqLoader(*(a[:BATCH] for a in data), batch_size=BATCH)
    trainers = {
        name: SeqTrainer(HSTUModel(**SERVE, generator=torch.Generator().manual_seed(1), device="cuda"), vocab_chunk_size=chunk)
        for name, chunk in (("chunked 8192", 8192), ("dense", None))
    }
    for tr in trainers.values():  # warm-up: cuBLAS handles, allocator, the optimizer's state
        tr.train_one_epoch(first, log_interval=0)
    torch.cuda.synchronize()
    before = {name: [p.detach().clone() for p in tr.model.parameters()] for name, tr in trainers.items()}

    reset_counts()
    results = {}
    for name, tr in trainers.items():
        t0 = time.perf_counter()
        loss = tr.train_one_epoch(loader, log_interval=0)  # ends in a host read of the losses
        results[name] = (loss, time.perf_counter() - t0)
    rab._FUSED_BWD[0] = False  # one step through the split pair K2a + K2b
    try:
        split_loss = trainers["chunked 8192"].train_one_epoch(first, log_interval=0)
    finally:
        rab._FUSED_BWD[0] = True
    counts = read_counts()

    fused_steps = len(trainers) * TRAIN_BATCHES
    print(f"  launches over {fused_steps} steps + 1 split step, {n_layers} layers: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
    expected = {"hstu_rab_fwd": n_layers * (fused_steps + 1), "hstu_rab_bwd": n_layers * fused_steps, "hstu_rab_bwd_dq": n_layers, "hstu_rab_bwd_dkv": n_layers}
    if counts != expected:
        raise AssertionError(f"the training path did not run each kernel once per layer per step: {counts}, expected {expected}")
    tokens = BATCH * TRAIN_BATCHES * l
    for name, (loss, seconds) in results.items():
        print(f"  {name}: train loss {loss:.6f}, {tokens / seconds:,.0f} tokens/s, {seconds / TRAIN_BATCHES * 1e3:.3f} ms per step of {BATCH} x L{l} (host clock, {TRAIN_BATCHES} steps)")
        if not (math.isfinite(loss) and 0 < loss < 2 * math.log(vocab)):
            raise AssertionError(f"training loss out of range ({name}): {loss}")
        moved = [float((p.detach() - q).abs().max()) > 0 for p, q in zip(trainers[name].model.parameters(), before[name])]
        if not all(moved):
            raise AssertionError(f"{moved.count(False)} parameters did not move ({name})")
    print(f"  split-pair step (K2a + K2b): loss {split_loss:.6f}")
    if not math.isfinite(split_loss):
        raise AssertionError("the split-pair step gave a non-finite loss")

    # where a training step's time goes: its stages on one batch, device time
    # against the host clock (the difference is the device waiting for the host)
    toks, _, tds, tgts = next(iter(first))
    toks, tds, tgts = (torch.from_numpy(a).cuda() for a in (toks, tds, tgts))
    cotangent = torch.from_numpy(np.random.default_rng(2).normal(size=(BATCH, l, SERVE["d_model"])).astype(np.float32)).cuda()
    for name, tr in trainers.items():
        tr.model.train()

        def fwd_layers_bwd(tr=tr):  # the layers' backward alone: a cotangent on the hidden states
            tr.optimizer.zero_grad(set_to_none=True)
            tr.model(toks, tds, return_hidden=True, generator=tr.generator)["hidden"].backward(cotangent)

        def fwd_bwd(tr=tr):
            tr.optimizer.zero_grad(set_to_none=True)
            tr.loss_fn(toks, tds, tgts).backward()

        def fwd_layers_bwd_split(tr=tr):  # the same through the split pair K2a + K2b
            rab._FUSED_BWD[0] = False
            try:
                fwd_layers_bwd(tr)
            finally:
                rab._FUSED_BWD[0] = True

        stages = {
            "forward": (f"forward, {n_layers} HSTU layers (hidden states, autograd on)", lambda tr=tr: tr.model(toks, tds, return_hidden=True, generator=tr.generator)),
            "layers": ("forward + backward of the hidden states (no loss)", fwd_layers_bwd),
            "layers split": ("forward + backward of the hidden states (no loss), _FUSED_BWD[0] = False: K2a + K2b", fwd_layers_bwd_split),
            "loss": ("forward + loss", lambda tr=tr: tr.loss_fn(toks, tds, tgts)),
            "loss bwd": ("forward + loss + backward", fwd_bwd),
            "step": ("train_step (+ Adam)", lambda tr=tr: tr.train_step(toks, tds, tgts)),
        }
        t = {}
        for key, (stage, fn) in stages.items():
            device, wall = timed(fn, cycles_per_ms)
            t[key] = device
            print(f"  {name} stage {stage}: device {device:.4f} ms, host clock {wall:.4f} ms, device idle {1 - device / wall:.0%} (medians of {REPS})")
        print(f"  {name} by difference (device ms): forward {t['forward']:.4f}, loss {t['loss'] - t['forward']:.4f}, "
              f"backward of the layers and embeddings {t['layers'] - t['forward']:.4f} (through K2a + K2b: {t['layers split'] - t['forward']:.4f}), "
              f"backward of the loss {t['loss bwd'] - t['loss'] - (t['layers'] - t['forward']):.4f}, Adam and zero_grad {t['step'] - t['loss bwd']:.4f}")

    for name, tr in trainers.items():
        kernel_breakdown(name, lambda tr=tr: tr.train_step(toks, tds, tgts))

    # one batch's parameter gradients against the same weights without the kernels
    fused = trainers["chunked 8192"]
    plain = SeqTrainer(HSTUModel(**SERVE, use_fused_kernel=False, device="cuda"), vocab_chunk_size=8192)
    plain.model.load_state_dict(fused.model.state_dict())
    for tr in (fused, plain):
        tr.model.train()
        tr.optimizer.zero_grad(set_to_none=True)
        tr.loss_fn(toks, tds, tgts).backward()
    worst = (0.0, "")
    for (pname, a), b in zip(fused.model.named_parameters(), plain.model.parameters(), strict=True):
        diff = (a.grad - b.grad).abs()
        ratio = float((diff / (GRAD_ATOL_REL * float(b.grad.abs().max()) + 1e-12 + GRAD_RTOL * b.grad.abs())).max())
        worst = max(worst, (ratio, pname))
        if not (torch.isfinite(a.grad).all() and ratio <= 1.0):
            raise AssertionError(f"the fused model's gradient of {pname} disagrees with the unfused one: max abs err {float(diff.max()):.3e}, ratio {ratio:.3f}")
    print(f"  fused vs unfused parameter gradients, one batch: worst max |d|/(atol+rtol|ref|) {worst[0]:.3f} ({worst[1]}; rtol {GRAD_RTOL}, atol {GRAD_ATOL_REL} x the tensor's max |ref|)")
    return counts


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    print("build:")
    seconds = _build.build_all()
    for name, log in _build.build_log.items():
        print(f"  {name}:\n" + "\n".join("    " + line for line in log.strip().splitlines()))
    print(f"  built in {seconds:.2f} s")
    for shape in ((256, 32, 32, 256, 128), (1024, 32, 32, 1024, 128)):
        occ = rab.occupancy(*shape)
        print(f"  L{shape[0]} dqk {shape[1]} dv {shape[2]}: " + "; ".join(f"{k}: {c} CTAs per SM, {r} registers, {b:,} B shared per CTA" for k, (c, r, b) in occ.items()))

    cycles_per_ms = spin_cycles_per_ms()
    cases = kernel_cases()
    print("kernel phase (hstu_rab_fwd vs plain PyTorch, fp32):")
    measured = {"hstu_rab_fwd": kernel_phase(cases, cycles_per_ms)}
    print("backward kernel phase (hstu_rab_bwd, hstu_rab_bwd_dq + hstu_rab_bwd_dkv vs the plain backward, fp32):")
    measured.update(backward_phase(cases, cycles_per_ms))
    print("bucket sweep (hstu_rab_fwd, hstu_rab_bwd and hstu_rab_bwd_dq + hstu_rab_bwd_dkv at every threshold -1, 0, +1 and |dt| = 2**31, vs the plain version on the CPU):")
    for name, err in sweep_phase().items():
        measured[name]["max_abs_err"] = max(measured[name]["max_abs_err"], err)
    del cases
    print("materialised-bias attention phase (hstu_attention: hstu_attn_fwd vs plain PyTorch and vs hstu_rab_fwd, fp32):")
    k3 = attention_phase(bias_cases(), cycles_per_ms)

    print("serving phase (full-width HSTU through SeqTrainer):")
    launches = {name: 0 for name in COUNTERS}
    launches["hstu_rab_fwd"] = serving_phase(cycles_per_ms)
    print("training phase (full-width HSTU through SeqTrainer.train_one_epoch):")
    for name, n in training_phase(cycles_per_ms).items():
        launches[name] += n

    sources = {"hstu_rab_fwd": ("hstu_rab_fwd.cu", "hstu_rab_attention.py:267"), **{k: ("hstu_rab_bwd.cu", f"hstu_rab_attention.py:{v['line']}") for k, v in BWD_KERNELS.items()},
               "hstu_attn_fwd": ("hstu_attn_fwd.cu", "hstu_attention.py:45")}
    launches["hstu_attn_fwd"] = k3.pop("launches")  # the op's own path: it lies on no model's path
    measured["hstu_attn_fwd"] = k3
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"torch_rechub_tpu_torch/csrc/{src}",
        "replaces": f"torch_rechub_tpu/ops/pallas/{tpu}",
        "launches": launches[name],  # serving path + training path; K3: the calls of its own phase
        "max_abs_err": measured[name]["max_abs_err"],
        "ms": measured[name]["ms"],
        "plain_ms": measured[name]["plain_ms"],
        "bound_ms": measured[name]["bound_ms"],
        "bound_by": measured[name]["bound_by"],
        # no single PyTorch call computes silu attention, or its backward, with a
        # rab bias: scaled_dot_product_attention has a softmax
        "library_ms": None,
    } for name, (src, tpu) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
