"""Device ms a training step of the tables' gathers: the work inside the ``rechub.sparse.gather`` ranges on the
device (labelled slice)."""

from cardbench.layer_metrics._spans import device_ms


def read(ctx):
    return device_ms(ctx, "rechub.sparse.gather")
