"""Parameter initializers, drawn from an explicit ``torch.Generator``.

Values are drawn on the CPU (where the generator lives) and copied into the
parameter, so one seed gives the same weights on every device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


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


def linear(in_features: int, out_features: int, generator: Optional[torch.Generator] = None, device=None) -> torch.nn.Linear:
    """``nn.Linear`` with the zoo's init: torch fan-in weight, zero bias (flax ``Dense``)."""
    layer = torch.nn.Linear(in_features, out_features, device=device)
    torch_linear_init_(layer.weight, generator)
    torch.nn.init.zeros_(layer.bias)
    return layer
