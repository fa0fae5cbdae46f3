"""Deep & Cross Network (ADKDD'2017, arXiv:1708.05123).

Counterpart of ``torch_rechub_tpu/models/ranking/dcn.py``: a cross network
and an MLP side by side over the flat embeddings, concatenated into LR.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from ...basic.layers import LR, MLP, CrossNetwork, mlp_width
from ...ops.embedding import EmbeddingCollection, squeeze_width


class DCN(nn.Module):
    """``forward(x)`` takes a dict of ``(B,)`` tensors and returns ``(B,)`` logits."""

    def __init__(self, features: Sequence, n_cross_layers: int, mlp_params: Dict[str, Any], generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.features = tuple(features)
        d = squeeze_width(self.features)
        self.EmbeddingCollection_0 = EmbeddingCollection(self.features, generator=generator, device=device)
        self.CrossNetwork_0 = CrossNetwork(d, n_cross_layers, generator, device)
        self.MLP_0 = MLP(d, output_layer=False, **mlp_params, generator=generator, device=device)
        self.LR_0 = LR(d + mlp_width(d, mlp_params), generator=generator, device=device)

    def forward(self, x: Mapping[str, torch.Tensor], generator: Optional[torch.Generator] = None) -> torch.Tensor:
        embed_x = self.EmbeddingCollection_0(x, self.features, squeeze_dim=True)
        cn_out = self.CrossNetwork_0(embed_x)
        mlp_out = self.MLP_0(embed_x, generator=generator)
        return self.LR_0(torch.cat([cn_out, mlp_out], dim=1)).squeeze(-1)
