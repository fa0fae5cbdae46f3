"""AutoInt (CIKM'2019, arXiv:1810.11921).

Counterpart of ``torch_rechub_tpu/models/ranking/autoint.py``: stacked
multi-head ``InteractingLayer``s over the field embeddings, plus LR over the
flat inputs and an optional MLP; each dense feature is projected to the
shared embed dim by its own ``dense_{name}`` (``Dense(1 -> D)``, no bias).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from ...basic.initializers import linear
from ...basic.layers import LR, MLP, InteractingLayer
from ...ops.embedding import EmbeddingCollection


class AutoInt(nn.Module):
    """``forward(x)`` takes a dict of ``(B,)`` tensors and returns ``(B,)`` logits."""

    def __init__(self, sparse_features: Sequence, dense_features: Sequence = (), num_layers: int = 3, num_heads: int = 2, dropout: float = 0.0, mlp_params: Optional[Dict[str, Any]] = None, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.sparse_features, self.dense_features = tuple(sparse_features), tuple(dense_features or ())
        if not self.sparse_features:
            raise ValueError("AutoInt requires at least one sparse feature to determine embed_dim.")
        self.num_layers, self.has_mlp = num_layers, mlp_params is not None
        embed_dim = self.sparse_features[0].embed_dim
        flat = (len(self.sparse_features) + len(self.dense_features)) * embed_dim
        self.EmbeddingCollection_0 = EmbeddingCollection(self.sparse_features, generator=generator, device=device)
        for fea in self.dense_features:
            self.add_module(f"dense_{fea.name}", linear(1, embed_dim, generator, device, bias=False))
        for i in range(num_layers):
            self.add_module(f"InteractingLayer_{i}", InteractingLayer(embed_dim, num_heads, dropout, generator=generator, device=device))
        self.attn_linear = linear(flat, 1, generator, device)
        self.LR_0 = LR(flat, generator=generator, device=device)
        if self.has_mlp:
            self.MLP_0 = MLP(flat, **mlp_params, generator=generator, device=device)

    def forward(self, x: Mapping[str, torch.Tensor], generator: Optional[torch.Generator] = None) -> torch.Tensor:
        parts = [self.EmbeddingCollection_0(x, self.sparse_features)]  # (B, F, D)
        for fea in self.dense_features:
            parts.append(getattr(self, f"dense_{fea.name}")(x[fea.name].to(torch.float32).reshape(-1, 1, 1)))
        embed_x = torch.cat(parts, dim=1)
        flat = embed_x.reshape(embed_x.shape[0], -1)
        attn = embed_x
        for i in range(self.num_layers):
            attn = getattr(self, f"InteractingLayer_{i}")(attn, generator=generator)
        y = self.attn_linear(attn.reshape(attn.shape[0], -1)) + self.LR_0(flat)
        if self.has_mlp:
            y = y + self.MLP_0(flat, generator=generator)
        return y.squeeze(-1)
