"""Device ms a training step of rank 0's collectives: the work inside the program's ``rechub.dist.all_reduce``
(the gradients' sum over the data group) and ``rechub.dist.all_gather`` (the sparse rows' ids and gradients over
it) ranges on the device (labelled slice)."""

from cardbench.layer_metrics._union import device_ms


def read(ctx):
    return device_ms(ctx, ("rechub.dist.all_reduce", "rechub.dist.all_gather"))
