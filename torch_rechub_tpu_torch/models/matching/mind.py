"""MIND (arXiv:1904.08030), multi-interest retrieval by capsule routing.

Counterpart of ``torch_rechub_tpu/models/matching/mind.py``: a
``CapsuleNetwork`` (bilinear type 0, random routing start) extracts
``interest_num`` interests from the history; each, beside the user
features, goes through ``convert_user_weight`` and is L2-normalised.
Training picks the interest closest to the positive item and scores it
against the positive and the negatives; ``mode="user"`` returns the
``(B, K, D)`` interests for multi-interest retrieval.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ...basic.initializers import param, uniform
from ...basic.layers import CapsuleNetwork
from ...basic.precision import einsum, promote
from ...ops.embedding import EmbeddingCollection
from .base import l2_normalize
from .youtube_dnn import item_tower_with_negatives


class MultiInterestFrame(nn.Module):
    """The two-tower frame MIND and Comirec (``comirec.py``) share; a subclass sets ``_interests(hist, mask, generator)``."""

    def __init__(self, user_features: Sequence, history_features: Sequence, item_features: Sequence, neg_item_feature: Sequence, temperature: float = 1.0, interest_num: int = 4, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.user_features, self.history_features = tuple(user_features), tuple(history_features)
        self.item_features, self.neg_item_feature = tuple(item_features), tuple(neg_item_feature)
        self.temperature, self.interest_num = temperature, interest_num
        self.embedding = EmbeddingCollection(self.user_features + self.item_features + self.history_features + self.neg_item_feature, generator=generator, device=device)
        user_dims = sum(f.embed_dim for f in self.user_features + self.history_features)
        self.convert_user_weight = param(uniform(1.0), (user_dims, self.history_features[0].embed_dim), generator, device)

    def _interests(self, hist, mask, generator):  # pragma: no cover - abstract
        raise NotImplementedError

    def user_tower(self, x, generator=None) -> torch.Tensor:
        input_user = self.embedding(x, self.user_features, squeeze_dim=True)[:, None, :]
        hist = self.embedding(x, self.history_features)[:, 0]  # (B, L, D)
        mask = (x[self.history_features[0].name] > 0).to(torch.float32)
        interests = self._interests(hist, mask, generator)  # (B, K, D)
        combined = torch.cat([input_user.expand(-1, self.interest_num, -1), interests], dim=-1)
        return l2_normalize(promote(combined) @ self.convert_user_weight, axis=-1)

    def item_tower(self, x, generator=None, with_negatives: bool = False):
        return item_tower_with_negatives(self.embedding, x, self.item_features, self.neg_item_feature, with_negatives)

    @staticmethod
    def _best(user: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """The interest of ``user (B, K, D)`` with the largest score against ``pos (B, D)``, ``(B, 1, D)``."""
        k_idx = torch.argmax(einsum("bkd,bd->bk", user, pos), dim=1)
        return user[torch.arange(user.shape[0], device=user.device), k_idx][:, None, :]

    def towers(self, x, generator=None):
        user, item = self.user_tower(x, generator), self.item_tower(x, generator)
        return self._best(user, item)[:, 0], item

    def forward(self, x, mode=None, generator=None):
        if mode == "user":
            return self.user_tower(x, generator)
        if mode == "item":
            return self.item_tower(x, generator)
        user = self.user_tower(x, generator)
        item = self.item_tower(x, generator, with_negatives=True)  # (B, 1 + n, D)
        return (self._best(user, item[:, 0]) * item).sum(-1)


class MIND(MultiInterestFrame):
    def __init__(self, user_features, history_features, item_features, neg_item_feature, max_length: int, temperature: float = 1.0, interest_num: int = 4, generator: Optional[torch.Generator] = None, device=None):
        super().__init__(user_features, history_features, item_features, neg_item_feature, temperature, interest_num, generator, device)
        self.max_length = max_length
        self.capsule = CapsuleNetwork(self.history_features[0].embed_dim, max_length, bilinear_type=0, interest_num=interest_num, generator=generator, device=device)

    def _interests(self, hist, mask, generator):
        return self.capsule(hist, mask, generator)
