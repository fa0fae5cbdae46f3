"""FaceBookDSSM (KDD'2020, arXiv:2006.11632), the pair-wise two-tower model.

Counterpart of ``torch_rechub_tpu/models/matching/dssm_facebook.py``: one
item MLP over the positive and the negative item's features; ``forward``
returns ``(pos_score, neg_score)`` for BPR.  ``mode="item"`` returns the item
MLP's output without the L2 norm, as in the JAX package; ``towers``
normalises it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from ...basic.layers import MLP
from ...ops.embedding import EmbeddingCollection, squeeze_width
from .base import l2_normalize


class FaceBookDSSM(nn.Module):
    def __init__(self, user_features: Sequence, pos_item_features: Sequence, neg_item_features: Sequence, user_params: Dict[str, Any], item_params: Dict[str, Any], temperature: float = 1.0, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.user_features, self.pos_item_features, self.neg_item_features = tuple(user_features), tuple(pos_item_features), tuple(neg_item_features)
        self.temperature = temperature
        self.embedding = EmbeddingCollection(self.user_features + self.pos_item_features + self.neg_item_features, generator=generator, device=device)
        self.user_mlp = MLP(squeeze_width(self.user_features), **user_params, output_layer=False, generator=generator, device=device)
        self.item_mlp = MLP(squeeze_width(self.pos_item_features), **item_params, output_layer=False, generator=generator, device=device)

    def user_tower(self, x, generator=None):
        return l2_normalize(self.user_mlp(self.embedding(x, self.user_features, squeeze_dim=True), generator=generator), axis=1)

    def item_tower(self, x, generator=None):
        return self.item_mlp(self.embedding(x, self.pos_item_features, squeeze_dim=True), generator=generator)

    def towers(self, x, generator=None):
        return self.user_tower(x, generator), l2_normalize(self.item_tower(x, generator), axis=1)

    def forward(self, x, mode=None, generator=None):
        if mode == "user":
            return self.user_tower(x, generator)
        if mode == "item":
            return self.item_tower(x, generator)
        user = self.user_tower(x, generator)
        pos = l2_normalize(self.item_mlp(self.embedding(x, self.pos_item_features, squeeze_dim=True), generator=generator), axis=1)
        neg = l2_normalize(self.item_mlp(self.embedding(x, self.neg_item_features, squeeze_dim=True), generator=generator), axis=1)
        return (user * pos).sum(1), (user * neg).sum(1)
