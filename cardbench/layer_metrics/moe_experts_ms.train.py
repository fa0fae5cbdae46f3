"""Device ms a training step of the held experts' products, forward and backward: the work inside the program's
``rechub.moe.experts`` and ``rechub.moe.experts.bwd`` ranges on the device (labelled slice)."""

from cardbench.layer_metrics._union import device_ms


def read(ctx):
    return device_ms(ctx, ("rechub.moe.experts", "rechub.moe.experts.bwd"))
