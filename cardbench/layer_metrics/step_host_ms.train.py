"""Host ms a training step inside the program's ``rechub.train_step`` span: the step's enqueue time, the host's
whole share of the step (lean slice)."""

from cardbench.layer_metrics._spans import host_ms


def read(ctx):
    return host_ms(ctx, "rechub.train_step")
