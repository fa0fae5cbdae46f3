"""Device ms a request of the retrieval's ``torch.topk``: the work inside the ``rechub.retrieval.topk`` range on the
device (labelled slice), the scoring product left out."""

from cardbench.layer_metrics._spans import device_ms


def read(ctx):
    return device_ms(ctx, "rechub.retrieval.topk")
