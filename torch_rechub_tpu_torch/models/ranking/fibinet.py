"""FiBiNet (RecSys'19).

Counterpart of ``torch_rechub_tpu/models/ranking/fibinet.py``: SENet field
re-weighting, then one bilinear interaction layer applied to both the raw
and the re-weighted embeddings, concatenated into an MLP.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from ...basic.features import SparseFeature
from ...basic.layers import MLP, BiLinearInteractionLayer, SENETLayer
from ...ops.embedding import EmbeddingCollection


class FiBiNet(nn.Module):
    """``forward(x)`` takes a dict of ``(B,)`` tensors and returns ``(B,)`` logits.

    Every field shares one embed_dim; ``num_fields`` counts the sparse
    features that own their table, as in the JAX package.
    """

    def __init__(self, features: Sequence, mlp_params: Dict[str, Any], reduction_ratio: int = 3, bilinear_type: str = "field_interaction", generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.features = tuple(features)
        num_fields = len([f for f in self.features if isinstance(f, SparseFeature) and f.shared_with is None])
        embed_dim = self.features[0].embed_dim
        self.EmbeddingCollection_0 = EmbeddingCollection(self.features, generator=generator, device=device)
        self.SENETLayer_0 = SENETLayer(num_fields, reduction_ratio, generator, device)
        self.BiLinearInteractionLayer_0 = BiLinearInteractionLayer(num_fields, embed_dim, bilinear_type, generator, device)
        self.MLP_0 = MLP(num_fields * (num_fields - 1) * embed_dim, **mlp_params, generator=generator, device=device)

    def forward(self, x: Mapping[str, torch.Tensor], generator: Optional[torch.Generator] = None) -> torch.Tensor:
        embed_x = self.EmbeddingCollection_0(x, self.features)
        embed_senet = self.SENETLayer_0(embed_x)
        bilinear = self.BiLinearInteractionLayer_0
        shallow = torch.cat([bilinear(embed_x), bilinear(embed_senet)], dim=1).reshape(embed_x.shape[0], -1)
        return self.MLP_0(shallow, generator=generator).squeeze(-1)
