#!/usr/bin/env python3
"""Drive the PyTorch port (``torch_rechub_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

1. Card: its name and power limit; fails without a CUDA device.
2. Build: every CUDA source of the port, with nvcc, from this checkout.
3. Kernels: each kernel against its plain PyTorch version on the card, at the
   serving shape and at adversarial ones, with a stated tolerance, and timed
   beside its bound: the forward K1, then the backward K2 and K2a + K2b
   against the plain backward, on all five gradients.
4. Serving: the full-width HSTU model of ``benchmarks/perf/hstu_train_bench.py``
   (V40000, d256, 8 heads, 4 layers, L256, batch 8) with random weights from a
   seed, through ``SeqTrainer.evaluate`` / ``predict_logits``, dense and
   chunked; the kernels' launch counts over that run; the fused model's
   logits against the same weights without the kernel.
5. Training: the same configuration through ``SeqTrainer.train_one_epoch``,
   chunked 8192 (the bench's path) and dense, on seeded bench-style data;
   tokens/s, ms per step, and where a step's time goes; the loss finite and
   every parameter moved; K1 and K2 launched once per layer per step, and
   one step with ``_FUSED_BWD[0] = False`` through K2a and K2b; one batch's
   parameter gradients against the same weights without the kernels.
6. One JSON line of kernels, then the last line ``{"ok": true, "device": ...}``.

Any failure raises, so the exit code is not 0 and the last line is not printed.
Float32 throughout, TF32 off.
"""

from __future__ import annotations

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
from torch_rechub_tpu_torch.ops.cuda import _build  # noqa: E402
from torch_rechub_tpu_torch.ops.cuda import hstu_rab_attention as rab  # noqa: E402
from torch_rechub_tpu_torch.trainers.seq_trainer import SeqTrainer  # noqa: E402
from torch_rechub_tpu_torch.utils.data import SeqLoader  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
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
    call's device work back to back and not the host's launch cost.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    spin = int(3 * max(walls) * cycles_per_ms)
    times = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(spin)
        ev[1].record()
        t0 = time.perf_counter()
        fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        if enqueue_ms >= ev[0].elapsed_time(ev[1]):
            raise AssertionError("the host enqueued for longer than the device waited: the device time would count host time")
        times.append(ev[1].elapsed_time(ev[2]))
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


def bound(flops, nbytes):
    """(bound ms, what bounds it): fp32 FLOPs at the fp32 peak vs bytes at the HBM rate."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def input_bytes(c):
    return sum(t.numel() * t.element_size() for t in c.values() if isinstance(t, torch.Tensor))


def rab_bound(c):
    """K1: 2 (dqk + dv) FLOP per valid pair; inputs read and the output written once."""
    dqk, dv = c["q"].shape[-1], c["v"].shape[-1]
    return bound(2 * valid_pairs(c) * (dqk + dv), input_bytes(c) + c["v"].numel() * 4)


def bwd_bound(c, g, kernel, outs):
    """A backward kernel: its FMAs per valid pair; inputs and g read, its outputs written once."""
    fq, fv = BWD_KERNELS[kernel]["fma"]
    dqk, dv = c["q"].shape[-1], c["v"].shape[-1]
    return bound(2 * valid_pairs(c) * (fq * dqk + fv * dv), input_bytes(c) + g.numel() * 4 + sum(o.numel() * 4 for o in outs))


def kernel_cases():
    return {
        "serve B8 L256 sorted times, suffix padding": rab_case(0, 8, 256, 256),
        "B8 L256 shuffled times, scattered mask, one empty row": rab_case(1, 8, 256, 256, times="shuffled", mask="scattered"),
        "B8 L256 stamps at both ends of int32 (wrapping differences)": rab_case(5, 8, 256, 256, times="wrapping"),
        "B8 L256 no times, mask None": rab_case(2, 8, 256, 256, times=None, mask=None),
        "B8 L200 ragged, maxL256": rab_case(3, 8, 200, 256),
        "B8 L1024 maxL1024": rab_case(4, 8, 1024, 1024),
    }


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
            bound_ms, bound_by = rab_bound(c)
            timings[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
            print(f"    device time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
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
                bound_ms, bound_by = bwd_bound(c, g, kernel, got.values())
                timings.setdefault(kernel, {})[case] = dict(ms=ms, bound_ms=bound_ms, bound_by=bound_by)
                print(f"    {kernel} device {ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, {valid_pairs(c):,} valid pairs), host clock per call {wall:.4f} ms")
        if case.startswith("serve") or "L1024" in case:
            plain_ms, plain_wall = timed(lambda: rab.dense_backward(*args[:-1], c["ts"] is not None), cycles_per_ms)
            for kernel in BWD_KERNELS:
                timings[kernel][case]["plain_ms"] = plain_ms
            print(f"    plain backward device {plain_ms:.4f} ms, host clock {plain_wall:.4f} ms (medians of {REPS})")
    print(f"  tolerances: dq/dk/dv rtol {BWD_RTOL} atol {BWD_ATOL}; dpos/dts rtol {TABLE_RTOL}, atol {TABLE_ATOL_REL} x the table's max |ref|")
    return {kernel: dict(max_abs_err=worst[kernel], **next(iter(timings[kernel].values()))) for kernel in BWD_KERNELS}


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
    for key, label in (("hstu_rab_fwd_kernel", "K1 hstu_rab_fwd"), ("bwd_kv_kernel<", "K2 / K2b hstu_rab_bwd(_dkv)"), ("bwd_q_kernel<", "K2a hstu_rab_bwd_dq")):
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

        stages = {
            f"forward, {n_layers} HSTU layers (hidden states, autograd on)": lambda tr=tr: tr.model(toks, tds, return_hidden=True, generator=tr.generator),
            "forward + backward of the hidden states (no loss)": fwd_layers_bwd,
            "forward + loss": lambda tr=tr: tr.loss_fn(toks, tds, tgts),
            "forward + loss + backward": fwd_bwd,
            "train_step (+ Adam)": lambda tr=tr: tr.train_step(toks, tds, tgts),
        }
        t = []
        for stage, fn in stages.items():
            device, wall = timed(fn, cycles_per_ms)
            t.append(device)
            print(f"  {name} stage {stage}: device {device:.4f} ms, host clock {wall:.4f} ms, device idle {1 - device / wall:.0%} (medians of {REPS})")
        print(f"  {name} by difference (device ms): forward {t[0]:.4f}, loss {t[2] - t[0]:.4f}, backward of the layers and embeddings {t[1] - t[0]:.4f}, "
              f"backward of the loss {t[3] - t[2] - (t[1] - t[0]):.4f}, Adam and zero_grad {t[4] - t[3]:.4f}")

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

    cycles_per_ms = spin_cycles_per_ms()
    cases = kernel_cases()
    print("kernel phase (hstu_rab_fwd vs plain PyTorch, fp32):")
    measured = {"hstu_rab_fwd": kernel_phase(cases, cycles_per_ms)}
    print("backward kernel phase (hstu_rab_bwd, hstu_rab_bwd_dq + hstu_rab_bwd_dkv vs the plain backward, fp32):")
    measured.update(backward_phase(cases, cycles_per_ms))
    del cases

    print("serving phase (full-width HSTU through SeqTrainer):")
    launches = {name: 0 for name in COUNTERS}
    launches["hstu_rab_fwd"] = serving_phase(cycles_per_ms)
    print("training phase (full-width HSTU through SeqTrainer.train_one_epoch):")
    for name, n in training_phase(cycles_per_ms).items():
        launches[name] += n

    sources = {"hstu_rab_fwd": ("hstu_rab_fwd.cu", 267), **{k: ("hstu_rab_bwd.cu", v["line"]) for k, v in BWD_KERNELS.items()}}
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"torch_rechub_tpu_torch/csrc/{src}",
        "replaces": f"torch_rechub_tpu/ops/pallas/hstu_rab_attention.py:{line}",
        "launches": launches[name],  # serving path + training path
        "max_abs_err": measured[name]["max_abs_err"],
        "ms": measured[name]["ms"],
        "plain_ms": measured[name]["plain_ms"],
        "bound_ms": measured[name]["bound_ms"],
        "bound_by": measured[name]["bound_by"],
        "library_ms": None,  # no single PyTorch call computes silu attention, or its backward, with a rab bias
    } for name, (src, line) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
