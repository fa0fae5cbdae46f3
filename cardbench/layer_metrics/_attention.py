"""Roofline shares of the HSTU attention kernels in a trace, against the frozen bounds of ``counts/attention.py``.

Each traced step or request has its own valid pairs (its histories' lengths),
so its calls are held to its own bound; every step or request calls each
kernel once a layer.
"""

import re

from cardbench.counts.attention import bwd_bound, rab_bound

# every kernel that implements the forward: K1 and its width-tiled variant (role 0, fp32)
FORWARD = re.compile(r"hstu_rab_fwd_kernel|wide_kernel<float, 0, true")
# the backward: K2, or K2a + K2b, the table sums' second kernel, the width-tiled roles 1 and 2
BACKWARD = re.compile(r"bwd_fused_kernel<|bwd_q_kernel<|bwd_kv_kernel<|reduce_table_slices|wide_kernel<float, [12], true")
# one per call of the backward: K2, or K2a (the split's first kernel, or its variant)
BACKWARD_CALL = re.compile(r"bwd_fused_kernel<|bwd_q_kernel<|wide_kernel<float, 1, true")


def bound_ms(ctx, bound) -> float:
    """The least time of every call the traced steps or requests made, by the bound function ``bound``."""
    c = ctx.cfg
    total = 0.0
    for w in ctx.traced_work:
        shape = dict(b=w["rows"], h=c["n_heads"], l=ctx.traffic["history_len"], dqk=c["dqk"], dv=c["dv"], max_seq_len=c["max_seq_len"], num_buckets=c["num_time_buckets"])
        total += c["n_layers"] * bound(**shape, pairs=c["n_heads"] * w["pairs"])["bound_ms"]
    return total


def share(ctx, pattern, call_pattern, bound):
    kernels = [(n, s, e) for n, s, e in ctx.trace.kernels() if pattern.search(n)]
    calls = sum(1 for n, _, _ in kernels if call_pattern.search(n))
    if not calls:
        return None
    least = bound_ms(ctx, bound) * calls / (ctx.cfg["n_layers"] * len(ctx.traced_work))  # the calls the trace holds
    return 100.0 * least * 1e-3 / sum(e - s for _, s, e in kernels)


def forward(ctx):
    return share(ctx, FORWARD, FORWARD, rab_bound)


def backward(ctx):
    return share(ctx, BACKWARD, BACKWARD_CALL, bwd_bound)
