"""Device ms a request inside the benchmark's ``cardbench.retrieval`` span around ``brute_force_topk``:
the union of the device's work within the span as it ran on the device (the labelled slice)."""

from cardbench.trace import union_length


def read(ctx):
    lab = ctx.trace.labelled
    spans = [(s, e) for n, s, e in lab.device_spans if n == "cardbench.retrieval"]
    if not spans:
        return None
    work = [(s, e) for _, s, e in lab.device]
    return 1e3 * sum(union_length(work, lo, hi) for lo, hi in spans) / lab.n
