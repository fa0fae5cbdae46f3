"""GRU4Rec (arXiv:1511.06939) in the two-tower protocol.

Counterpart of ``torch_rechub_tpu/models/matching/gru4rec.py``: stacked GRU
layers without biases over the history's embeddings, the last layer's final
state beside the user features into the user MLP; items as in YoutubeDNN.
As in the JAX package the GRU runs over every step, PAD steps included, with
no mask (the reference runs ``nn.GRU`` on the unpacked batch).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from ...basic.layers import MLP
from ...ops.embedding import EmbeddingCollection, squeeze_width
from ...ops.rnn import GRULayer
from .base import l2_normalize
from .youtube_dnn import item_tower_with_negatives


class GRU4Rec(nn.Module):
    def __init__(self, user_features: Sequence, history_features: Sequence, item_features: Sequence, neg_item_feature: Sequence, user_params: Dict[str, Any], temperature: float = 1.0, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.user_features, self.history_features = tuple(user_features), tuple(history_features)
        self.item_features, self.neg_item_feature, self.temperature = tuple(item_features), tuple(neg_item_feature), temperature
        self.embedding = EmbeddingCollection(self.user_features + self.item_features + self.history_features + self.neg_item_feature, generator=generator, device=device)
        d = self.history_features[0].embed_dim
        self.num_layers = user_params.get("num_layers", 2)
        for i in range(self.num_layers):  # flax names a list of submodules gru_layers_{i}
            self.add_module(f"gru_layers_{i}", GRULayer(d, d, use_bias=False, generator=generator, device=device))
        mlp_params = {k: v for k, v in user_params.items() if k != "num_layers"}
        self.user_mlp = MLP(squeeze_width(self.user_features) + d, **mlp_params, output_layer=False, generator=generator, device=device)

    def user_tower(self, x, generator=None, keep_dim: bool = False):
        input_user = self.embedding(x, self.user_features, squeeze_dim=True)
        h = self.embedding(x, self.history_features)[:, 0]  # (B, L, D)
        h_last = None
        for i in range(self.num_layers):
            h, h_last = getattr(self, f"gru_layers_{i}")(h)
        emb = l2_normalize(self.user_mlp(torch.cat([input_user, h_last], dim=-1), generator=generator), dim=-1)
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
        user = self.user_tower(x, generator, keep_dim=True)
        return (user * self.item_tower(x, generator, with_negatives=True)).sum(2) / self.temperature
