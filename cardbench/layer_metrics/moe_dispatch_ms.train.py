"""Device ms a training step of the expert layers' routing and dispatch: the work inside the program's
``rechub.moe.route`` (router, top-k, balance loss), ``rechub.moe.dispatch`` (sort, gather, weighted scatter-add)
and ``rechub.moe.dispatch.bwd`` (their backward) ranges on the device (labelled slice).  The router's own backward
(softmax and top-k, a (positions x experts) matrix) runs outside any span."""

from cardbench.layer_metrics._union import device_ms


def read(ctx):
    return device_ms(ctx, ("rechub.moe.route", "rechub.moe.dispatch", "rechub.moe.dispatch.bwd"))
