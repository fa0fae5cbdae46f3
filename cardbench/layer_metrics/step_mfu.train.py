"""The model FLOPs of the untraced window (``counts/steps.py``, over the rows and positions each step or
request really held) over its seconds, as a share of the cards' fp32-accurate peak (``counts/peaks.py``:
3xTF32, 164.9 TFLOP/s a card)."""

from cardbench.counts.peaks import PEAK_FP32_ACCURATE_FLOPS


def read(ctx):
    return 100.0 * ctx.window["flops"] / ctx.window["seconds"] / (ctx.chips * PEAK_FP32_ACCURATE_FLOPS)
