"""Parameter initializers, drawn from an explicit ``torch.Generator``.

Values are drawn on the CPU (where the generator lives) and copied into the
parameter, so one seed gives the same weights on every device.

The embedding-table specs (``RandomNormal``, ``RandomUniform``,
``XavierNormal``, ``XavierUniform``, ``Pretrained``) are the counterparts of
``torch_rechub_tpu/basic/initializers.py``: frozen dataclasses that a feature
carries, whose ``init(shape, generator)`` returns a CPU float32 tensor.
``EmbeddingCollection`` owns the parameter and zeroes a ``padding_idx`` row.

The raw parameters of the layer zoo (``CIN``'s ``conv_w_{i}``, the bilinear
``w``, ``CrossNetMix``'s ``u / v / c``, AUGRU's matrices, ...) are drawn by
flax's rules, not torch's: :func:`variance_scaling` takes its fans as flax
does, and :func:`torch_linear_init`, :func:`xavier_uniform`,
:func:`xavier_normal`, :func:`uniform`, :func:`normal` and :func:`ones` are
the counterparts of the JAX package's initializers of those parameters.
``nn.Linear`` weights keep :func:`torch_linear_init_` (flax ``Dense``
kernels are ``(in, out)``, so the rules agree there).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch


class Initializer:
    """Base initializer spec; subclasses implement ``init(shape, generator)``."""

    def init(self, shape, generator: Optional[torch.Generator] = None) -> torch.Tensor:  # pragma: no cover - abstract
        raise NotImplementedError

    def __call__(self, shape, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.init(tuple(shape), generator).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class RandomNormal(Initializer):
    mean: float = 0.0
    std: float = 1e-4

    def init(self, shape, generator=None):
        return self.mean + self.std * torch.randn(shape, generator=generator)


@dataclasses.dataclass(frozen=True)
class RandomUniform(Initializer):
    minval: float = 0.0
    maxval: float = 1.0

    def init(self, shape, generator=None):
        return torch.empty(shape).uniform_(self.minval, self.maxval, generator=generator)


@dataclasses.dataclass(frozen=True)
class XavierNormal(Initializer):
    gain: float = 1.0

    def init(self, shape, generator=None):
        return self.gain * math.sqrt(2.0 / (shape[-2] + shape[-1])) * torch.randn(shape, generator=generator)


@dataclasses.dataclass(frozen=True)
class XavierUniform(Initializer):
    gain: float = 1.0

    def init(self, shape, generator=None):
        bound = self.gain * math.sqrt(6.0 / (shape[-2] + shape[-1]))
        return torch.empty(shape).uniform_(-bound, bound, generator=generator)


@dataclasses.dataclass(frozen=True, eq=False)
class Pretrained(Initializer):
    """Initialize from a host array of shape ``(vocab, dim)``.

    ``freeze`` is carried for the JAX package's API; no trainer reads it, in
    either package.
    """

    weights: Any = None
    freeze: bool = True

    def init(self, shape, generator=None):
        w = torch.as_tensor(np.asarray(self.weights), dtype=torch.float32)
        if tuple(w.shape) != tuple(shape):
            raise ValueError(f"Pretrained weights shape {tuple(w.shape)} != requested {tuple(shape)}")
        return w.clone()


def uniform_(param: torch.Tensor, bound: float, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """U(-bound, bound), drawn on the CPU and copied into ``param``."""
    values = torch.empty(param.shape, dtype=torch.float32).uniform_(-bound, bound, generator=generator)
    with torch.no_grad():
        param.copy_(values)
    return param


def torch_linear_init_(weight: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``nn.Linear``'s default weight init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)).

    Counterpart of ``basic/layers.py:torch_linear_init`` (variance scaling
    1/3, fan-in, uniform).  ``weight`` is ``(out, in)``, so fan-in is dim 1.
    """
    return uniform_(weight, 1.0 / math.sqrt(weight.shape[1]), generator)


def xavier_uniform_(table: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Glorot uniform, bound sqrt(6 / (fan_in + fan_out)) over a 2-D table."""
    return uniform_(table, math.sqrt(6.0 / (table.shape[0] + table.shape[1])), generator)


def flax_fans(shape) -> Tuple[float, float]:
    """flax's ``(fan_in, fan_out)``: axes -2 and -1, each times the product of the other axes (the receptive field)."""
    receptive = math.prod(shape) / shape[-2] / shape[-1]
    return shape[-2] * receptive, shape[-1] * receptive


def variance_scaling(scale: float, mode: str, distribution: str) -> Callable:
    """flax's ``variance_scaling(scale, mode, distribution)`` as ``init(shape, generator)``, for the modes
    ``"fan_in"`` / ``"fan_avg"`` and the distributions ``"uniform"`` / ``"truncated_normal"`` the zoo uses.

    ``truncated_normal`` draws N(0, 1) cut to [-2, 2] and divides the
    standard deviation by that law's own, 0.8796..., as flax does.
    """

    def init(shape, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        fan_in, fan_out = flax_fans(tuple(shape))
        variance = scale / (fan_in if mode == "fan_in" else (fan_in + fan_out) / 2)
        if distribution == "uniform":
            bound = math.sqrt(3.0 * variance)
            return torch.empty(shape).uniform_(-bound, bound, generator=generator)
        values = torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, 1.0, -2.0, 2.0, generator=generator)
        return values * (math.sqrt(variance) / 0.87962566103423978)

    return init


# basic/layers.py:torch_linear_init of the JAX package, on raw parameters (flax's fans)
torch_linear_init = variance_scaling(1.0 / 3.0, "fan_in", "uniform")
xavier_uniform = variance_scaling(1.0, "fan_avg", "uniform")
xavier_normal = variance_scaling(1.0, "fan_avg", "truncated_normal")


def uniform(scale: float = 1.0) -> Callable:
    """flax ``initializers.uniform(scale)``: U[0, scale)."""
    return lambda shape, generator=None: torch.empty(shape).uniform_(0.0, scale, generator=generator)


def normal(stddev: float = 1.0) -> Callable:
    """flax ``initializers.normal(stddev)``: N(0, stddev²)."""
    return lambda shape, generator=None: stddev * torch.randn(shape, generator=generator)


def ones(shape, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return torch.ones(shape)


def zeros(shape, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return torch.zeros(shape)


def param(init: Callable, shape, generator: Optional[torch.Generator] = None, device=None) -> torch.nn.Parameter:
    """A parameter of ``shape`` drawn on the CPU by ``init(shape, generator)`` and moved to ``device``."""
    return torch.nn.Parameter(init(tuple(shape), generator).to(torch.float32).to(device))


def linear(in_features: int, out_features: int, generator: Optional[torch.Generator] = None, device=None, bias: bool = True) -> torch.nn.Linear:
    """``nn.Linear`` with the zoo's init: torch fan-in weight, zero bias (flax ``Dense``)."""
    layer = torch.nn.Linear(in_features, out_features, bias=bias, device=device)
    torch_linear_init_(layer.weight, generator)
    if bias:
        torch.nn.init.zeros_(layer.bias)
    return layer
