"""Core layers: the prediction head, LR, MLP with flax-semantics BatchNorm, FM.

Counterpart of ``torch_rechub_tpu/basic/layers.py:36-100``.  flax infers a
``Dense``'s input width at its first call; here every layer takes an
explicit ``in_features``, which the models work out from the feature schema.
Submodules keep flax's automatic names (``Dense_0``, ``BatchNorm_0``, ...),
so a flax model's ``params`` and ``batch_stats`` load by name
(``utils/jax_weights.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .activation import activation_layer
from .hstu import dropout
from .initializers import linear


def prediction(x: torch.Tensor, task_type: str = "classification") -> torch.Tensor:
    """Head transform: sigmoid for classification, identity for regression."""
    if task_type not in ("classification", "regression"):
        raise ValueError("task_type must be classification or regression")
    return torch.sigmoid(x) if task_type == "classification" else x


class LR(nn.Module):
    """First-order linear term ``(B, in_features) -> (B, 1)``; optional sigmoid."""

    def __init__(self, in_features: int, sigmoid: bool = False, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.sigmoid = sigmoid
        self.Dense_0 = linear(in_features, 1, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.Dense_0(x)
        return torch.sigmoid(out) if self.sigmoid else out


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis (``use_fast_variance=True``), not ``nn.BatchNorm1d``.

    In training the batch is normalised by its mean and its *biased*
    variance ``E[x²] − E[x]²`` clamped at 0, and the running statistics
    become ``momentum·ra + (1 − momentum)·stat``, the variance biased too
    (``nn.BatchNorm1d`` would store the unbiased one, and eval outputs would
    drift by n/(n−1)).  The statistics are unweighted: every row of the
    batch counts.  The running ``mean`` starts at 0 and ``var`` at 1; in eval
    they normalise.  ``weight`` and ``bias`` are flax's ``scale`` and ``bias``.
    """

    def __init__(self, num_features: int, momentum: float = 0.9, eps: float = 1e-5, device=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("mean", torch.zeros(num_features, device=device))
        self.register_buffer("var", torch.ones(num_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        if self.training:
            flat = x.reshape(-1, x.shape[-1])
            mean = flat.mean(0)
            var = torch.clamp_min((flat * flat).mean(0) - mean * mean, 0.0)
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class MLP(nn.Module):
    """``Dense -> BatchNorm -> activation -> dropout`` per hidden layer, then an optional ``Dense(1)``.

    BatchNorm momentum 0.9 (flax's convention: the weight of the old
    statistics), eps 1e-5.  Dropout draws its masks from the ``generator``
    given to ``forward``.
    """

    def __init__(self, in_features: int, dims: Sequence[int] = (), output_layer: bool = True, dropout: float = 0.0, activation: str = "relu", generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.dims, self.output_layer, self.dropout = tuple(dims), output_layer, dropout
        self.activations = []
        for i, dim in enumerate(self.dims):
            self.add_module(f"Dense_{i}", linear(in_features, dim, generator, device))
            self.add_module(f"BatchNorm_{i}", BatchNorm(dim, device=device))
            act = activation_layer(activation, generator, device)
            if isinstance(act, nn.Module):  # Dice / PReLU hold a parameter: flax names them Dice_i / PReLU_i
                self.add_module(f"{type(act).__name__}_{i}", act)
            self.activations.append(act)
            in_features = dim
        if output_layer:
            self.add_module(f"Dense_{len(self.dims)}", linear(in_features, 1, generator, device))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i, act in enumerate(self.activations):
            x = getattr(self, f"BatchNorm_{i}")(getattr(self, f"Dense_{i}")(x))
            x = dropout(act(x), self.dropout, self.training, generator)
        if self.output_layer:
            x = getattr(self, f"Dense_{len(self.dims)}")(x)
        return x


class FM(nn.Module):
    """Second-order FM interaction ``0.5 * ((Σv)² − Σv²)`` over ``(B, F, D)``."""

    def __init__(self, reduce_sum: bool = True):
        super().__init__()
        self.reduce_sum = reduce_sum

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ix = x.sum(1) ** 2 - (x**2).sum(1)
        if self.reduce_sum:
            ix = ix.sum(1, keepdim=True)
        return 0.5 * ix
