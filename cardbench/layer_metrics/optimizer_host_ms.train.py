"""Host ms a training step in the dense optimizer's step, the ``rechub.train.optimizer`` stage of each step (lean slice)."""

from cardbench.layer_metrics._spans import host_ms


def read(ctx):
    return host_ms(ctx, "rechub.train_step", "rechub.train.optimizer")
