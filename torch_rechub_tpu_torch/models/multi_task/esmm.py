"""ESMM (SIGIR'2018, arXiv:1804.07931), entire-space CVR modelling.

Counterpart of ``torch_rechub_tpu/models/multi_task/esmm.py``: shared
embeddings, a CVR and a CTR tower, ``ctcvr = ctr · cvr``; ``forward``
returns the ``[cvr, ctr, ctcvr]`` probabilities as ``(B, 3)``.  The
trainer's loss covers ctr and ctcvr only.  The towers read the stacked
sparse embeddings (``squeeze_dim=False``), so dense features among the
given ones are left out, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from ...basic.features import DenseFeature
from ...basic.layers import MLP
from ...ops.embedding import EmbeddingCollection, squeeze_width


class ESMM(nn.Module):
    def __init__(self, user_features: Sequence, item_features: Sequence, cvr_params: Dict[str, Any], ctr_params: Dict[str, Any], generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.user_features, self.item_features = tuple(user_features), tuple(item_features)
        self.embedding = EmbeddingCollection(self.user_features + self.item_features, generator=generator, device=device)
        width = squeeze_width(tuple(f for f in self.user_features + self.item_features if not isinstance(f, DenseFeature)))
        self.tower_cvr = MLP(width, **cvr_params, generator=generator, device=device)
        self.tower_ctr = MLP(width, **ctr_params, generator=generator, device=device)

    def forward(self, x: Mapping[str, torch.Tensor], generator: Optional[torch.Generator] = None) -> torch.Tensor:
        user = self.embedding(x, self.user_features, squeeze_dim=False)
        item = self.embedding(x, self.item_features, squeeze_dim=False)
        b = user.shape[0]
        input_tower = torch.cat([user.reshape(b, -1), item.reshape(b, -1)], dim=1)
        cvr_pred = torch.sigmoid(self.tower_cvr(input_tower, generator=generator))
        ctr_pred = torch.sigmoid(self.tower_ctr(input_tower, generator=generator))
        return torch.cat([cvr_pred, ctr_pred, ctr_pred * cvr_pred], dim=1)
