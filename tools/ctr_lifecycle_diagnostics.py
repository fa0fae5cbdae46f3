#!/usr/bin/env python3
"""Two measurements behind the DeepFM part of ``chip_smoke.py``'s lifecycle phase, on one CUDA card:

    python3 tools/ctr_lifecycle_diagnostics.py

1. ``prefetch_to_device`` against synchronous copies at the Criteo-full geometry (``chip_smoke.VOCABS_FULL``,
   zipf ids, sparse Adagrad, B4096): the host time to hand 16 groups to the card each way, epochs of 16 steps in
   turn, and torch.profiler's CPU time of an epoch each way with its top operations.
2. How far apart runs of 16 steps land: three straight runs and two resumed ones (8 steps, a checkpoint, a fresh
   trainer, ``maybe_resume``, 8 more), each pair's largest relative difference (each tensor's max |a - b| over its
   max |b|; the Dense biases in front of a BatchNorm, whose exact gradient is 0, left out) and how many tensors
   are equal; then two straight runs and a resumed one under ``torch.use_deterministic_algorithms``.

Exits with a message when no CUDA device is present.
"""

import os
import shutil
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as c  # noqa: E402
from torch_rechub_tpu_torch.data import prefetch_to_device  # noqa: E402

STEPS, HALF = 16, 8
SCRATCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build", "ctr_lifecycle_diagnostics")


def build():
    return c.CTRTrainer(c.ctr_model(c.VOCABS_FULL, seed=12, device=c.CARD), optimizer_params=c.CTR_OPT, sparse_embedding="adagrad")


def loaders():
    b = c.CTR["batch"]
    x, y = c.ctr_data(STEPS * b, c.VOCABS_FULL, seed=12, zipf=True)
    half = HALF * b
    return {"all": c.ArrayLoader(x, y, batch_size=b), "first": c.ArrayLoader({k: v[:half] for k, v in x.items()}, y[:half], batch_size=b),
            "second": c.ArrayLoader({k: v[half:] for k, v in x.items()}, y[half:], batch_size=b)}


def prefetch_against_synchronous(tr, loader):
    from torch.profiler import ProfilerActivity, profile

    groups = list(tr._iter_groups(loader))
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        [tr._to_device(*g) for g in groups]
        torch.cuda.synchronize()
        t_sync = time.perf_counter() - t0
        t0 = time.perf_counter()
        list(prefetch_to_device(iter(groups), size=2, device=c.CARD))
        torch.cuda.synchronize()
        print(f"  {len(groups)} groups to the card: synchronous copies {t_sync * 1e3:.2f} ms, prefetch_to_device {(time.perf_counter() - t0) * 1e3:.2f} ms")
    ways = {"prefetch": tr._groups, "synchronous": lambda dl: (tr._to_device(*g) for g in tr._iter_groups(dl))}
    tr.train_one_epoch(loader, log_interval=0)
    for _ in range(2):
        for name, fn in ways.items():
            tr._groups = fn
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train_one_epoch(loader, log_interval=0)
            torch.cuda.synchronize()
            print(f"  an epoch of {STEPS} steps, {name}: {(time.perf_counter() - t0) * 1e3:.1f} ms (host clock)")
    for name, fn in ways.items():
        tr._groups = fn
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tr.train_one_epoch(loader, log_interval=0)
            torch.cuda.synchronize()
        events = prof.key_averages()
        total = sum(e.self_cpu_time_total for e in events) / 1e3
        top = sorted(events, key=lambda e: -e.self_cpu_time_total)[:6]
        print(f"  {name}: {total:.1f} ms of CPU time an epoch (torch.profiler); " + ", ".join(f"{e.key} {e.self_cpu_time_total / 1e3:.1f} ms ({e.count})" for e in top))


def straight(ld):
    tr = build()
    tr.train_one_epoch(ld["all"], log_interval=0)
    p = c.params_of(tr)
    del tr
    torch.cuda.empty_cache()
    return p


def resumed(ld, directory):
    first = build()
    first.enable_step_checkpointing(directory, every_n_steps=HALF, max_to_keep=1)
    first.train_one_epoch(ld["first"], log_interval=0)
    del first
    tr = build()
    tr.enable_step_checkpointing(directory, every_n_steps=HALF, max_to_keep=1)
    if tr.maybe_resume() != HALF:
        raise AssertionError("no checkpoint of step 8")
    tr.train_one_epoch(ld["second"], log_interval=0)
    p = c.params_of(tr)
    del tr
    torch.cuda.empty_cache()
    shutil.rmtree(directory)
    return p


def report(tag, runs):
    names = list(runs)
    exempt = c.shift_invariant(set(runs[names[0]]))
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            keep = [k for k in runs[b] if k not in exempt]
            d, at = c.rel_diff({k: runs[a][k] for k in keep}, {k: runs[b][k] for k in keep})
            same = sum(torch.equal(runs[a][k], runs[b][k]) for k in runs[b])
            print(f"  {tag}: {a} vs {b}: {d:.3e} ({at}; {len(exempt)} biases in front of a BatchNorm left out), {same} of {len(runs[b])} tensors equal")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("tools/ctr_lifecycle_diagnostics.py needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    ld = loaders()
    print("prefetch_to_device against synchronous copies:")
    tr = build()
    prefetch_against_synchronous(tr, ld["all"])
    del tr
    torch.cuda.empty_cache()
    print("run-to-run differences after 16 steps (s: straight, r: 8 + resume + 8):")
    runs = {f"s{i}": straight(ld) for i in range(3)}
    runs.update(r1=resumed(ld, os.path.join(SCRATCH, "r1")), r2=resumed(ld, os.path.join(SCRATCH, "r2")))
    report("default", runs)
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    runs = {"s0": straight(ld), "s1": straight(ld), "r1": resumed(ld, os.path.join(SCRATCH, "r3"))}
    report("deterministic", runs)
    shutil.rmtree(SCRATCH, ignore_errors=True)


if __name__ == "__main__":
    main()
