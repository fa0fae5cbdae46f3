#!/usr/bin/env python3
"""Drive the PyTorch port (``torch_rechub_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

1. Card: its name and power limit; fails without a CUDA device.
2. Build: every CUDA source of the serving path, with nvcc, from this checkout.
3. Kernels: each kernel against its plain PyTorch version on the card, at the
   serving shape and at adversarial ones, with a stated tolerance, and timed.
4. Serving: the full-width HSTU model of ``benchmarks/perf/hstu_train_bench.py``
   (V40000, d256, 8 heads, 4 layers, L256, batch 8) with random weights from a
   seed, through ``SeqTrainer.evaluate`` / ``predict_logits``, dense and
   chunked; the kernels' launch counts over that run; the fused model's
   logits against the same weights without the kernel.
5. One JSON line of kernels, then the last line ``{"ok": true, "device": ...}``.

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
# fused vs unfused model logits: the kernel's error carried through 4 layers and the vocab projection
LOGIT_RTOL, LOGIT_ATOL = 1e-4, 1e-4
SERVE = dict(vocab_size=40000, d_model=256, n_heads=8, n_layers=4, dqk=32, dv=32, max_seq_len=256, num_time_buckets=128, time_bucket_fn="sqrt", time_bucket_unit="minutes", tie_embeddings=True, dropout=0.0)
BATCH, N_BATCHES = 8, 4
REPS = 30


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


def rab_bound(c):
    """(bound ms, what bounds it): causal-half fp32 FLOPs vs bytes moved once."""
    b, h, l, dqk = c["q"].shape
    dv = c["v"].shape[-1]
    flops = 2 * b * h * (l * l / 2) * (dqk + dv)
    nbytes = sum(t.numel() * t.element_size() for k, t in c.items() if isinstance(t, torch.Tensor)) + b * h * l * dv * 4
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def kernel_phase(cycles_per_ms):
    cases = {
        "serve B8 L256 sorted times, suffix padding": rab_case(0, 8, 256, 256),
        "B8 L256 shuffled times, scattered mask, one empty row": rab_case(1, 8, 256, 256, times="shuffled", mask="scattered"),
        "B8 L256 stamps at both ends of int32 (wrapping differences)": rab_case(5, 8, 256, 256, times="wrapping"),
        "B8 L256 no times, mask None": rab_case(2, 8, 256, 256, times=None, mask=None),
        "B8 L200 ragged, maxL256": rab_case(3, 8, 200, 256),
        "B8 L1024 maxL1024": rab_case(4, 8, 1024, 1024),
    }
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


# ---------------------------------------------------------------------------
# 4. serving phase
# ---------------------------------------------------------------------------

def serving_data(n, l, vocab, seed=0):
    """Sequences as in hstu_train_bench.py:50-55, with a left-padded PAD prefix on half the rows."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab, (n, l)).astype(np.int32)
    for i in range(0, n, 2):
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

    rab.launches, forwards[0] = 0, 0
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
    print("kernel phase (hstu_rab_fwd vs plain PyTorch, fp32):")
    k1 = kernel_phase(cycles_per_ms)

    print("serving phase (full-width HSTU through SeqTrainer):")
    launches = serving_phase(cycles_per_ms)

    print(json.dumps({"kernels": [{
        "name": "hstu_rab_fwd",
        "route": "cuda",
        "source": "torch_rechub_tpu_torch/csrc/hstu_rab_fwd.cu",
        "replaces": "torch_rechub_tpu/ops/pallas/hstu_rab_attention.py:267",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,  # no single PyTorch call computes silu attention with a rab bias
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
