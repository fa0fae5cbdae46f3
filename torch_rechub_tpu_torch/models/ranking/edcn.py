"""EDCN (DLP-KDD'21): parallel cross and deep streams exchanging information
through a bridge and field-wise regulation gates.

Counterpart of ``torch_rechub_tpu/models/ranking/edcn.py``, which follows
the paper's gates: a softmax over the field axis of ``g / tau``, each
field's gate repeated over its embedding dims.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...basic.initializers import linear, ones, param
from ...basic.layers import LR, MLP, CrossLayer
from ...ops.embedding import EmbeddingCollection


class BridgeModule(nn.Module):
    """Combines the cross and deep streams of width ``d``: ``hadamard_product``, ``pointwise_addition``,
    ``concatenation`` (a ReLU ``Dense_0`` over both) or ``attention_pooling`` (a softmax attention on each)."""

    def __init__(self, d: int, bridge_type: str, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.bridge_type = bridge_type
        if bridge_type == "concatenation":
            self.Dense_0 = linear(2 * d, d, generator, device)
        elif bridge_type == "attention_pooling":
            for name in ("attention_x", "attention_h"):
                self.add_module(f"{name}_1", linear(d, d, generator, device))
                self.add_module(f"{name}_2", linear(d, d, generator, device, bias=False))
        elif bridge_type not in ("hadamard_product", "pointwise_addition"):
            raise ValueError(f"bridge_type={bridge_type} is not supported")

    def _attention(self, name: str, v: torch.Tensor) -> torch.Tensor:
        a = getattr(self, f"{name}_2")(F.relu(getattr(self, f"{name}_1")(v)))
        return torch.softmax(a, dim=-1)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        if self.bridge_type == "hadamard_product":
            return x * h
        if self.bridge_type == "pointwise_addition":
            return x + h
        if self.bridge_type == "concatenation":
            return F.relu(self.Dense_0(torch.cat([x, h], dim=-1)))
        return self._attention("attention_x", x) * x + self._attention("attention_h", h) * h


class RegulationModule(nn.Module):
    """Two field-wise gates ``softmax(g / tau) · F``, each field's gate repeated over its dims."""

    def __init__(self, num_fields: int, fea_dims: Tuple[int, ...], tau: float = 1.0, use_regulation: bool = True, device=None):
        super().__init__()
        self.num_fields, self.tau, self.use_regulation = num_fields, tau, use_regulation
        self.total = int(sum(fea_dims))
        if use_regulation:
            self.g1 = param(ones, (num_fields,), device=device)
            self.g2 = param(ones, (num_fields,), device=device)
            self.register_buffer("repeats", torch.tensor(fea_dims, device=device), persistent=False)

    def _gate(self, g: torch.Tensor) -> torch.Tensor:
        s = torch.softmax(g / self.tau, dim=-1) * self.num_fields
        return torch.repeat_interleave(s, self.repeats, output_size=self.total)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if not self.use_regulation:
            return x, x
        return self._gate(self.g1) * x, self._gate(self.g2) * x


class EDCN(nn.Module):
    """``forward(x)`` takes a dict of ``(B,)`` tensors and returns ``(B,)`` logits.

    The MLP of every layer is ``(ΣD, ΣD)`` whatever ``mlp_params["dims"]``
    says, as in the JAX package.  Submodules carry flax's names, which it
    gives by creation order: ``RegulationModule_0..n-1``, then per layer
    ``CrossLayer_i``, ``MLP_i``, ``BridgeModule_i``, and ``LR_0``.
    """

    def __init__(self, features: Sequence, n_cross_layers: int, mlp_params: Dict[str, Any], bridge_type: str = "hadamard_product", use_regulation_module: bool = True, temperature: float = 1.0, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.features, self.n_cross_layers = tuple(features), n_cross_layers
        fea_dims = tuple(f.embed_dim for f in self.features)
        dims = sum(fea_dims)
        mlp_params = {**mlp_params, "dims": (dims, dims)}
        self.EmbeddingCollection_0 = EmbeddingCollection(self.features, generator=generator, device=device)
        for i in range(n_cross_layers):
            self.add_module(f"RegulationModule_{i}", RegulationModule(len(self.features), fea_dims, temperature, use_regulation_module, device))
        for i in range(n_cross_layers):
            self.add_module(f"CrossLayer_{i}", CrossLayer(dims, generator, device))
            self.add_module(f"MLP_{i}", MLP(dims, output_layer=False, **mlp_params, generator=generator, device=device))
            self.add_module(f"BridgeModule_{i}", BridgeModule(dims, bridge_type, generator, device))
        self.LR_0 = LR(3 * dims, generator=generator, device=device)

    def forward(self, x: Mapping[str, torch.Tensor], generator: Optional[torch.Generator] = None) -> torch.Tensor:
        embed_x = self.EmbeddingCollection_0(x, self.features, squeeze_dim=True)
        cross_i, deep_i = self.RegulationModule_0(embed_x)
        cross_0, bridge_i = cross_i, None
        for i in range(self.n_cross_layers):
            if i > 0:
                cross_i, deep_i = getattr(self, f"RegulationModule_{i}")(bridge_i)
            cross_i = cross_i + getattr(self, f"CrossLayer_{i}")(cross_0, cross_i)
            deep_i = getattr(self, f"MLP_{i}")(deep_i, generator=generator)
            bridge_i = getattr(self, f"BridgeModule_{i}")(cross_i, deep_i)
        return self.LR_0(torch.cat([cross_i, deep_i, bridge_i], dim=1)).squeeze(-1)
