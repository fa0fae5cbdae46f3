"""Host ms a training step in ``loss.backward()``, the ``rechub.train.backward`` stage of each step (lean slice)."""

from cardbench.layer_metrics._spans import host_ms


def read(ctx):
    return host_ms(ctx, "rechub.train_step", "rechub.train.backward")
