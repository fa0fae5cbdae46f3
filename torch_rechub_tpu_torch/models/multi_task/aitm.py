"""AITM (KDD'2021, arXiv:2105.08489), adaptive information transfer.

Counterpart of ``torch_rechub_tpu/models/multi_task/aitm.py``: a bottom and
a tower per task; task ``i`` takes task ``i − 1``'s bottom output through
an info gate and fuses it with its own by a two-token attention.  Every
task is a binary classification.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from ...basic.initializers import linear
from ...basic.layers import MLP
from ...ops.embedding import EmbeddingCollection, squeeze_width


class AttentionLayer(nn.Module):
    """``(B, 2, D) -> (B, D)``: softmax over the two tokens of ``q·k / sqrt(D)``, pooling ``v``.  ``q_layer``,
    ``k_layer`` and ``v_layer`` are Dense layers without bias, torch's fan-in init."""

    def __init__(self, dim: int, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.dim = dim
        self.q_layer = linear(dim, dim, generator, device, bias=False)
        self.k_layer = linear(dim, dim, generator, device, bias=False)
        self.v_layer = linear(dim, dim, generator, device, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.q_layer(x), self.k_layer(x), self.v_layer(x)
        a = torch.softmax((q * k).sum(-1) / math.sqrt(float(self.dim)), dim=1)
        return (a[..., None] * v).sum(1)


class AITM(nn.Module):
    def __init__(self, features: Sequence, n_task: int, bottom_params: Dict[str, Any], tower_params_list: Sequence[Dict[str, Any]], generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.features, self.n_task = tuple(features), n_task
        self.embedding = EmbeddingCollection(self.features, generator=generator, device=device)
        width, d = squeeze_width(self.features), bottom_params["dims"][-1]
        for i in range(n_task):
            self.add_module(f"bottoms_{i}", MLP(width, output_layer=False, **bottom_params, generator=generator, device=device))
        for i in range(n_task):
            self.add_module(f"towers_{i}", MLP(d, **tower_params_list[i], generator=generator, device=device))
        for i in range(n_task - 1):
            self.add_module(f"info_gates_{i}", MLP(d, output_layer=False, dims=(d,), generator=generator, device=device))
            self.add_module(f"aits_{i}", AttentionLayer(d, generator, device))

    def forward(self, x: Mapping[str, torch.Tensor], generator: Optional[torch.Generator] = None) -> torch.Tensor:
        embed_x = self.embedding(x, self.features, squeeze_dim=True)
        input_towers = [getattr(self, f"bottoms_{i}")(embed_x, generator=generator) for i in range(self.n_task)]
        for i in range(1, self.n_task):
            info = getattr(self, f"info_gates_{i - 1}")(input_towers[i - 1], generator=generator)[:, None, :]
            input_towers[i] = getattr(self, f"aits_{i - 1}")(torch.cat([input_towers[i][:, None, :], info], dim=1))
        ys = [torch.sigmoid(getattr(self, f"towers_{i}")(h, generator=generator)) for i, h in enumerate(input_towers)]
        return torch.cat(ys, dim=1)
