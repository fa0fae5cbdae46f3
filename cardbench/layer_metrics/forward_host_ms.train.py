"""Host ms a training step in the forward and loss under the row recorder, the ``rechub.train.forward`` stage
of each step (lean slice)."""

from cardbench.layer_metrics._spans import host_ms


def read(ctx):
    return host_ms(ctx, "rechub.train_step", "rechub.train.forward")
