"""Device ms a step of the work inside any of several program spans' ranges on the device (labelled slice).

As ``_spans.device_ms`` for one span, with the ranges of every name merged
first, so that work inside two of them counts once.  ``None`` where the
program opened none of them.
"""

from cardbench.trace import merge, union_length


def device_ms(ctx, names):
    lab = ctx.trace.labelled
    ranges = merge([(s, e) for n, s, e in lab.device_spans if n in names])
    if not ranges:
        return None
    work = [(s, e) for _, s, e in lab.device]
    return 1e3 * sum(union_length(work, lo, hi) for lo, hi in ranges) / lab.n
