"""Host ms a request in the model's forward, the root ``rechub.hstu.forward`` spans of serving (lean slice)."""

from cardbench.layer_metrics._spans import host_ms


def read(ctx):
    return host_ms(ctx, "rechub.hstu.forward")
