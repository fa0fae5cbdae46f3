"""Activation functions and the activation factory.

Counterpart of ``torch_rechub_tpu/basic/activation.py``: sigmoid, relu,
dice, prelu, softmax, leakyrelu.  Dice and PReLU hold a parameter, so they
are ``nn.Module``s; the rest are plain functions.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class Dice(nn.Module):
    """Dice activation from the DIN paper (arXiv:1706.06978).

    Over the last axis: ``p = sigmoid((x - mean) / sqrt(Σ((x - mean)² + eps)))``,
    output ``p·x + (1 − p)·alpha·x`` with one learnable scalar ``alpha``
    drawn from N(0, 1).
    """

    def __init__(self, epsilon: float = 1e-3, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.alpha = nn.Parameter(torch.randn(1, generator=generator).to(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        avg = x32.mean(-1, keepdim=True)
        var = ((x32 - avg) ** 2 + self.epsilon).sum(-1, keepdim=True)
        ps = torch.sigmoid((x32 - avg) / torch.sqrt(var))
        return (ps * x32 + (1.0 - ps) * self.alpha * x32).to(x.dtype)


class PReLU(nn.Module):
    """PReLU with one shared learnable slope, starting at ``init_slope``."""

    def __init__(self, init_slope: float = 0.25, device=None):
        super().__init__()
        self.slope = nn.Parameter(torch.full((1,), init_slope, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.slope * x)


def activation_layer(act_name, generator: Optional[torch.Generator] = None, device=None):
    """An activation callable by name (a callable passes through).

    ``sigmoid | relu | dice | prelu | softmax | leakyrelu``; ``dice`` and
    ``prelu`` return a new module, which the caller registers.
    """
    if callable(act_name) and not isinstance(act_name, str):
        return act_name
    name = act_name.lower()
    if name == "sigmoid":
        return torch.sigmoid
    if name == "relu":
        return F.relu
    if name == "dice":
        return Dice(generator=generator, device=device)
    if name == "prelu":
        return PReLU(device=device)
    if name == "softmax":
        return lambda x: torch.softmax(x, dim=1)
    if name == "leakyrelu":
        return lambda x: F.leaky_relu(x, negative_slope=0.01)
    raise NotImplementedError(f"unsupported activation: {act_name!r}")
