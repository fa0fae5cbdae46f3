"""Closed-loop serving: one request after another, each the histories of ``batch`` users from a pool on the card.

Set-up builds the cell's kernels, the weights, the model (in eval) and the
pool, and serves two requests to warm every shape.  In the window each
request is timed from its issue to its top-k ids and scores on the host:
``serve_users_per_s`` is every user answered over the window's seconds; the
95th percentile of every request's latency is a per-layer reading, since a
closed loop runs the server at its capacity, where tails swing.  A traced
run then profiles a few more requests.  Once the model is freed, a sample
of the window's requests drawn from the seed is judged against the
reference's exact scores (``judge.serve_gaps``).
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from .. import judge, weights
from ..device import Phases, build_kernels, peak_bytes, release
from ..generators import GENERATORS
from ..sampling import sub_seed
from ..trace import capture

WARM_REQUESTS = 2
TRACED_REQUESTS = 32


def run(c, seed: int, seconds: float, trace: bool, device, t0: float, fault=None, overrides=None) -> dict:
    kind, cfg, traffic = c.kind, c.cfg, c.traffic
    specs, k, phases = kind.specs(cfg), traffic["top_k"], Phases(t0, device)
    phases.mark("imports and the card")
    build_kernels(kind.KERNELS["serve"], device)
    phases.mark("kernels")
    pool = GENERATORS[traffic["generator"]](traffic, cfg, seed, device)
    work = kind.work(pool)
    phases.mark("inputs")
    model = kind.build_model(cfg, weights.make(specs, seed, device), seed, device).eval()
    phases.mark("weights and model")
    serve = kind.serve if fault is None else fault(kind.serve)
    for i in range(WARM_REQUESTS):
        serve(model, kind.batch(pool, i), k)
    release(device)
    phases.mark("warm requests")
    setup_s = time.perf_counter() - t0

    latencies, answers, i = [], [], WARM_REQUESTS
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        issued = time.perf_counter()
        ids, scores = serve(model, kind.batch(pool, i), k)
        latencies.append(time.perf_counter() - issued)
        answers.append((i, ids, scores))
        i += 1
    window_s = time.perf_counter() - start
    users = sum(len(ids) for _, ids, _ in answers)
    flops = sum(kind.serve_flops(cfg, work[j % len(work)]) for j, _, _ in answers)

    traced = capture(lambda j: serve(model, kind.batch(pool, i + j), k), TRACED_REQUESTS) if trace else None
    memory = peak_bytes(device)
    rng = random.Random(sub_seed(seed, "checked requests"))
    chosen = sorted(rng.sample(range(len(answers)), min(traffic["checked_requests"], len(answers))))
    checked = [({n: t.clone() for n, t in kind.batch(pool, answers[j][0]).items()}, answers[j][1], answers[j][2]) for j in chosen]
    del model, pool, answers
    release(device)

    served, reference = reference_readings(kind, cfg, specs, checked, k, seed, device)
    checks = judge.serve_gaps(served, reference)
    phases.write()
    return {
        "correct": judge.verdict(checks, c.limits) and len(checked) > 0,
        "attempted": len(latencies),
        "failed": 0,
        "end_to_end": {"serve_users_per_s": users / window_s, "setup_s": setup_s},
        "window": {"n": len(latencies), "seconds": window_s, "flops": flops, "p95_ms": float(np.percentile(np.asarray(latencies) * 1e3, 95))},
        "traced_work": [work[(i + j) % len(work)] for j in range(TRACED_REQUESTS)] if trace else [],
        "memory_peak_bytes": memory,
        "trace": traced,
        "checks": checks,
        "checked": checked,
        "reference": reference,
    }


def reference_readings(kind, cfg, specs, checked, k: int, seed: int, device, tf32: bool = False):
    """``(served, reference)`` lists for ``judge.serve_gaps``: each checked request's answer and the reference's scores."""
    w = weights.make(specs, seed, device)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        served, refs = [], []
        for b, ids, scores in checked:
            ids_t, scores_t = torch.as_tensor(np.asarray(ids), device=device), torch.as_tensor(np.asarray(scores), device=device)
            served.append({"ids": ids_t, "scores": scores_t})
            refs.append(kind.reference_serve(cfg, w, b, ids_t, k))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    del w
    release(device)
    return served, refs
