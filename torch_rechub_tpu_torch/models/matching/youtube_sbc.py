"""YoutubeSBC (RecSys'2019): in-batch softmax with sampling-bias correction.

Counterpart of ``torch_rechub_tpu/models/matching/youtube_sbc.py``: the
``(B, B)`` cosine score matrix of the two MLP towers less
``log(sample_weight)`` per item (the column), then a circular gather, row
``i`` taking columns ``i, i+1, ..., i+n_neg`` (mod B), into ``(B, 1 + n_neg)``
logits with the positive in column 0, over ``temperature``.  The sample
weight is the ``sample_weight_feature`` as ``EmbeddingCollection`` serves
it (a ``DenseFeature`` passes its value through).  ``batch_size`` is kept
for the API; the batch comes from the inputs.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from ...basic.layers import MLP
from ...ops.embedding import EmbeddingCollection, squeeze_width
from .base import l2_normalize


class YoutubeSBC(nn.Module):
    def __init__(self, user_features: Sequence, item_features: Sequence, sample_weight_feature: Sequence, user_params: Dict[str, Any], item_params: Dict[str, Any], batch_size: int, n_neg: int = 3, temperature: float = 1.0, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.user_features, self.item_features, self.sample_weight_feature = tuple(user_features), tuple(item_features), tuple(sample_weight_feature)
        self.batch_size, self.n_neg, self.temperature = batch_size, n_neg, temperature
        self.embedding = EmbeddingCollection(self.user_features + self.item_features + self.sample_weight_feature, generator=generator, device=device)
        self.user_mlp = MLP(squeeze_width(self.user_features), **user_params, output_layer=False, generator=generator, device=device)
        self.item_mlp = MLP(squeeze_width(self.item_features), **item_params, output_layer=False, generator=generator, device=device)

    def user_tower(self, x, generator=None):
        return self.user_mlp(self.embedding(x, self.user_features, squeeze_dim=True), generator=generator)

    def item_tower(self, x, generator=None):
        return self.item_mlp(self.embedding(x, self.item_features, squeeze_dim=True), generator=generator)

    def towers(self, x, generator=None):
        return self.user_tower(x, generator), self.item_tower(x, generator)

    def forward(self, x, mode=None, generator=None):
        if mode == "user":
            return self.user_tower(x, generator)
        if mode == "item":
            return self.item_tower(x, generator)
        user, item = self.towers(x, generator)
        b = user.shape[0]
        pred = l2_normalize(user, dim=1) @ l2_normalize(item, dim=1).T  # (B, B) cosine
        sample_weight = self.embedding(x, self.sample_weight_feature, squeeze_dim=True).reshape(b)
        scores = pred - torch.log(sample_weight)  # the sampling-bias correction
        cols = (torch.arange(b, device=scores.device)[:, None] + torch.arange(self.n_neg + 1, device=scores.device)[None, :]) % b
        return torch.gather(scores, 1, cols) / self.temperature
