"""Closed-loop training: one ``train_step`` after another on batches from a pool made on the card.

Set-up builds the cell's kernels, the weights and the program's trainer,
and the pool; then it drives that same trainer through its first steps on
the pool's first batches, through the window's own call, reading what the
program's state says of them: each step's loss, the gradient each leaf's
optimizer took on the first step, and each leaf's change after them.  The
window then runs the same trainer on the next batches for ``seconds``,
ended by a synchronise: ``train_examples_per_s`` is every row it completed
over its seconds, and the window's model FLOPs count each step's own rows
and positions.  A traced run then profiles a few more steps.  Once the
program is freed, the reference runs the first steps again from the same
weights and inputs, and ``judge.train_gaps`` compares.
"""

from __future__ import annotations

import time

import torch

from .. import judge, weights
from ..device import Phases, build_kernels, peak_bytes, release, sync
from ..generators import GENERATORS
from ..trace import capture

TRACED_STEPS = 8


def change_norms(values, init) -> dict:
    return {n: float(torch.linalg.vector_norm(values[n] - init[n])) for n in init}


def run(c, seed: int, seconds: float, trace: bool, device, t0: float, fault=None, overrides=None) -> dict:
    kind, cfg, traffic = c.kind, c.cfg, c.traffic
    specs, phases = kind.specs(cfg), Phases(t0, device)
    phases.mark("imports and the card")
    build_kernels(kind.KERNELS["train"], device)
    phases.mark("kernels")
    pool = GENERATORS[traffic["generator"]](traffic, cfg, seed, device)
    work = kind.work(pool)
    phases.mark("inputs")
    trainer = kind.build_trainer(cfg, weights.make(specs, seed, device), seed, device)
    phases.mark("weights and trainer")
    if fault is not None:
        fault(trainer)
    first = traffic["first_steps"]
    losses, grads = [], None
    for i in range(first):
        losses.append(kind.train_step(trainer, kind.batch(pool, i)))
        if i == 0:
            grads = kind.first_grad_norms(cfg, trainer)
    program = {"losses": [float(x) for x in losses], "first_grad_norms": grads, "change_norms": change_norms(kind.values(cfg, trainer), weights.make(specs, seed, device))}
    checked = [{k: t.clone() for k, t in kind.batch(pool, i).items()} for i in range(first)]
    release(device)
    phases.mark("first steps")
    setup_s = time.perf_counter() - t0

    steps, start = 0, time.perf_counter()
    while time.perf_counter() - start < seconds:
        kind.train_step(trainer, kind.batch(pool, first + steps))
        steps += 1
    sync(device)
    window_s = time.perf_counter() - start
    done = [work[(first + i) % len(work)] for i in range(steps)]

    traced = None
    if trace:
        traced = capture(lambda i: kind.train_step(trainer, kind.batch(pool, first + steps + i)), TRACED_STEPS)
    memory = peak_bytes(device)
    del trainer, pool, losses
    release(device)

    reference = reference_readings(kind, cfg, specs, checked, seed, device)
    checks = judge.train_gaps(program, reference)
    phases.write()
    return {
        "correct": judge.verdict(checks, c.limits),
        "attempted": steps,
        "failed": 0,
        "end_to_end": {"train_examples_per_s": sum(w["rows"] for w in done) / window_s, "setup_s": setup_s},
        "window": {"n": steps, "seconds": window_s, "flops": sum(kind.train_flops(cfg, w) for w in done)},
        "traced_work": [work[(first + steps + i) % len(work)] for i in range(TRACED_STEPS)] if trace else [],
        "memory_peak_bytes": memory,
        "trace": traced,
        "checks": checks,
        "program": program,
        "reference": reference,
        "checked": checked,
    }


def reference_readings(kind, cfg, specs, batches, seed: int, device, tf32: bool = False) -> dict:
    """The reference's first steps from the run's weights: ``tf32`` runs it as the control, in TF32."""
    w = weights.make(specs, seed, device)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        out = kind.reference_train(cfg, w, batches, seed, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    out["change_norms"] = change_norms(w, weights.make(specs, seed, device))
    del w
    release(device)
    return out
