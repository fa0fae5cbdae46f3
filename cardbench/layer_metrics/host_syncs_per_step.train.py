"""Host runtime calls a training step that wait for the device (``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize``, a blocking ``cudaMemcpy``) that start inside a
``rechub.train_step`` host range, on any thread (labelled slice); the slice's closing synchronise lies outside."""

from cardbench.layer_metrics._spans import calls_inside


def read(ctx):
    return calls_inside(ctx, "rechub.train_step")
