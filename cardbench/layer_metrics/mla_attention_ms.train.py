"""Device ms a training step of the latent attention, forward and backward, its projections included: the work
inside the program's ``rechub.mla.attention`` and ``rechub.mla.attention.bwd`` ranges on the device (labelled
slice)."""

from cardbench.layer_metrics._union import device_ms


def read(ctx):
    return device_ms(ctx, ("rechub.mla.attention", "rechub.mla.attention.bwd"))
