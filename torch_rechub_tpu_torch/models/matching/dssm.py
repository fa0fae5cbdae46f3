"""DSSM (CIKM'2013) and its SENet variant.

Counterpart of ``torch_rechub_tpu/models/matching/dssm.py``: an MLP tower
over each side's flattened embeddings, L2-normalised, and the dot product
as the score.  ``forward`` returns the raw score (the trainer's losses take
logits).  DSSM's score is not divided by ``temperature``; DSSMSENet's is,
as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from ...basic.features import SequenceFeature, SparseFeature
from ...basic.layers import MLP, SENETLayer
from ...ops.embedding import EmbeddingCollection, squeeze_width
from .base import l2_normalize


class DSSM(nn.Module):
    def __init__(self, user_features: Sequence, item_features: Sequence, user_params: Dict[str, Any], item_params: Dict[str, Any], temperature: float = 1.0, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.user_features, self.item_features, self.temperature = tuple(user_features), tuple(item_features), temperature
        self.embedding = EmbeddingCollection(self.user_features + self.item_features, generator=generator, device=device)
        self.user_mlp = MLP(squeeze_width(self.user_features), **user_params, output_layer=False, generator=generator, device=device)
        self.item_mlp = MLP(squeeze_width(self.item_features), **item_params, output_layer=False, generator=generator, device=device)

    def user_tower(self, x: Mapping[str, torch.Tensor], generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return l2_normalize(self.user_mlp(self.embedding(x, self.user_features, squeeze_dim=True), generator=generator), dim=1)

    def item_tower(self, x: Mapping[str, torch.Tensor], generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return l2_normalize(self.item_mlp(self.embedding(x, self.item_features, squeeze_dim=True), generator=generator), dim=1)

    def towers(self, x, generator=None):
        return self.user_tower(x, generator), self.item_tower(x, generator)

    def forward(self, x: Mapping[str, torch.Tensor], mode: Optional[str] = None, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if mode == "user":
            return self.user_tower(x, generator)
        if mode == "item":
            return self.item_tower(x, generator)
        user, item = self.towers(x, generator)
        return (user * item).sum(1)


def _n_fields(features) -> int:
    return len([f for f in features if isinstance(f, (SparseFeature, SequenceFeature))])


class DSSMSENet(nn.Module):
    """DSSM with SENet field gating of each tower's embeddings."""

    def __init__(self, user_features: Sequence, item_features: Sequence, user_params: Dict[str, Any], item_params: Dict[str, Any], temperature: float = 1.0, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.user_features, self.item_features, self.temperature = tuple(user_features), tuple(item_features), temperature
        self.embedding = EmbeddingCollection(self.user_features + self.item_features, generator=generator, device=device)
        self.user_mlp = MLP(squeeze_width(self.user_features), **user_params, output_layer=False, generator=generator, device=device)
        self.item_mlp = MLP(squeeze_width(self.item_features), **item_params, output_layer=False, generator=generator, device=device)
        self.n_user, self.n_item = _n_fields(self.user_features), _n_fields(self.item_features)
        self.user_senet = SENETLayer(self.n_user, generator=generator, device=device)
        self.item_senet = SENETLayer(self.n_item, generator=generator, device=device)

    def _tower(self, x, features, n_fields, senet, mlp, generator):
        inp = self.embedding(x, features, squeeze_dim=True)
        inp = senet(inp.reshape(inp.shape[0], n_fields, -1)).reshape(inp.shape[0], -1)
        return l2_normalize(mlp(inp, generator=generator), dim=1)

    def user_tower(self, x, generator=None):
        return self._tower(x, self.user_features, self.n_user, self.user_senet, self.user_mlp, generator)

    def item_tower(self, x, generator=None):
        return self._tower(x, self.item_features, self.n_item, self.item_senet, self.item_mlp, generator)

    def towers(self, x, generator=None):
        return self.user_tower(x, generator), self.item_tower(x, generator)

    def forward(self, x, mode=None, generator=None):
        if mode == "user":
            return self.user_tower(x, generator)
        if mode == "item":
            return self.item_tower(x, generator)
        user, item = self.towers(x, generator)
        return (user * item).sum(1) / self.temperature
