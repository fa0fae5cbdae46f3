"""Device ms a training step of the row-wise sparse updates: the work inside the ``rechub.train.sparse_update``
range on the device (labelled slice)."""

from cardbench.layer_metrics._spans import device_ms


def read(ctx):
    return device_ms(ctx, "rechub.train.sparse_update")
