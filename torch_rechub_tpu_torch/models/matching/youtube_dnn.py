"""YoutubeDNN (RecSys'2016), the list-wise two-tower model.

Counterpart of ``torch_rechub_tpu/models/matching/youtube_dnn.py``: a user
MLP tower against the raw item embeddings, both L2-normalised; the training
output is the ``(B, 1 + n_neg)`` score matrix (positive first) over
``temperature``, for the list-wise cross-entropy.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from ...basic.layers import MLP
from ...ops.embedding import EmbeddingCollection, squeeze_width
from .base import l2_normalize


def item_tower_with_negatives(embedding, x, item_features, neg_item_feature, with_negatives: bool) -> torch.Tensor:
    """The L2-normalised positive item ``(B, D)``, or with the negatives ``(B, 1 + n_neg, D)``."""
    pos = l2_normalize(embedding(x, item_features), dim=-1)  # (B, 1, D)
    if not with_negatives:
        return pos[:, 0, :]
    neg = l2_normalize(embedding(x, neg_item_feature)[:, 0], dim=-1)  # (B, n_neg, D)
    return torch.cat([pos, neg], dim=1)


class YoutubeDNN(nn.Module):
    def __init__(self, user_features: Sequence, item_features: Sequence, neg_item_feature: Sequence, user_params: Dict[str, Any], temperature: float = 1.0, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.user_features, self.item_features, self.neg_item_feature = tuple(user_features), tuple(item_features), tuple(neg_item_feature)
        self.temperature = temperature
        self.embedding = EmbeddingCollection(self.user_features + self.item_features + self.neg_item_feature, generator=generator, device=device)
        self.user_mlp = MLP(squeeze_width(self.user_features), **user_params, output_layer=False, generator=generator, device=device)

    def user_tower(self, x, generator=None, keep_dim: bool = False):
        emb = l2_normalize(self.user_mlp(self.embedding(x, self.user_features, squeeze_dim=True), generator=generator), dim=-1)
        return emb[:, None, :] if keep_dim else emb

    def item_tower(self, x, generator=None, with_negatives: bool = False):
        return item_tower_with_negatives(self.embedding, x, self.item_features, self.neg_item_feature, with_negatives)

    def towers(self, x, generator=None):
        return self.user_tower(x, generator), self.item_tower(x, generator)

    def forward(self, x, mode=None, generator=None):
        if mode == "user":
            return self.user_tower(x, generator)
        if mode == "item":
            return self.item_tower(x, generator)
        user = self.user_tower(x, generator, keep_dim=True)  # (B, 1, D)
        item = self.item_tower(x, generator, with_negatives=True)  # (B, 1 + n_neg, D)
        return (user * item).sum(2) / self.temperature
