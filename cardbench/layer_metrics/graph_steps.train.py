"""Share of the lean slice's training steps that replayed the step as CUDA graphs, in %: the ``rechub.train_step``
roots that hold a ``rechub.train.graph`` child (program span).  ``None`` for a program whose trainer keeps no graph
path (its ``utils/profiling.py`` has no ``counters``), or where the lean slice recorded no steps of its own."""

from cardbench.layer_metrics._spans import recorded


def read(ctx):
    from torch_rechub_tpu_torch.utils import profiling

    record, n = recorded(), ctx.trace.lean.n
    if not hasattr(profiling, "counters") or not record:
        return None
    roots = [i for i, (name, parent, _, end) in enumerate(record) if name == "rechub.train_step" and parent is None and end is not None]
    if len(roots) < 2 * n:  # the lean slice's own steps come first
        return None
    lean = set(roots[:n])
    graphed = {parent for name, parent, _, _ in record if name == "rechub.train.graph" and parent in lean}
    return 100.0 * len(graphed) / n
