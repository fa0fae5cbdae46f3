"""What the program's own spans say (``torch_rechub_tpu_torch/utils/profiling.py``, every name ``rechub.*``).

- Host ms come from the program's in-memory record of the lean slice, the
  one that profiles the device alone: ``capture`` runs it first, so of the
  ``2n`` root spans of a name that the two slices open, its ``n`` are the
  first.  A stage is a child of those roots, by ``parent``.
- Device ms are the union of the device's work inside each of a span's
  ranges as it ran on the device (its user annotation), in the labelled slice.
- Host runtime calls are counted where they start inside a span's host
  range in the labelled slice, on any thread.

Each returns ``None`` where the program opened no such span: a program
without them, or a cell that does not run that code.
"""

from cardbench.trace import merge, union_length

# CUDA runtime calls that hold the host until the device is done
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


def recorded():
    """The program's span record ``[(name, parent, start_ns, end_ns)]``, or ``None`` where it keeps none."""
    from torch_rechub_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    return None if read is None else read()


def host_ms(ctx, root: str, stage: str = None):
    """Host ms a step or request in the lean slice's first ``n`` root spans ``root``, or in their children ``stage``."""
    record, n = recorded(), ctx.trace.lean.n
    if not record:
        return None
    roots = [i for i, (name, parent, _, end) in enumerate(record) if name == root and parent is None and end is not None]
    if len(roots) < 2 * n:  # the lean slice recorded none of its own
        return None
    if stage is None:
        picked = [record[i] for i in roots[:n]]
    else:
        first = set(roots[:n])
        picked = [s for s in record if s[0] == stage and s[1] in first and s[3] is not None]
    return 1e-6 * sum(end - start for _, _, start, end in picked) / n if picked else None


def device_ms(ctx, name: str):
    """Device ms a step or request of the work inside span ``name``'s ranges on the device, in the labelled slice."""
    lab = ctx.trace.labelled
    ranges = merge([(s, e) for n, s, e in lab.device_spans if n == name])
    if not ranges:
        return None
    work = [(s, e) for _, s, e in lab.device]
    return 1e3 * sum(union_length(work, lo, hi) for lo, hi in ranges) / lab.n


def calls_inside(ctx, name: str, calls=SYNC_CALLS):
    """Host runtime calls ``calls`` a step or request that start inside span ``name``'s host ranges, in the labelled slice."""
    lab = ctx.trace.labelled
    ranges = merge([(s, e) for n, s, e in lab.host_ops if n == name])
    if not ranges:
        return None
    return sum(1 for n, s, _ in lab.host_ops if n in calls and any(lo <= s <= hi for lo, hi in ranges)) / lab.n
