"""Wide & Deep (DLRS'2016, arXiv:1606.07792).

Counterpart of ``torch_rechub_tpu/models/ranking/widedeep.py``: LR over the
wide features and an MLP over the deep features, summed into one logit.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from ...basic.layers import LR, MLP
from ...ops.embedding import EmbeddingCollection, squeeze_width


class WideDeep(nn.Module):
    """``forward(x)`` takes a dict of ``(B,)`` tensors and returns ``(B,)`` logits."""

    def __init__(self, wide_features: Sequence, deep_features: Sequence, mlp_params: Dict[str, Any], generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.wide_features, self.deep_features = tuple(wide_features), tuple(deep_features)
        self.EmbeddingCollection_0 = EmbeddingCollection(self.wide_features + self.deep_features, generator=generator, device=device)
        self.LR_0 = LR(squeeze_width(self.wide_features), generator=generator, device=device)
        self.MLP_0 = MLP(squeeze_width(self.deep_features), **mlp_params, generator=generator, device=device)

    def forward(self, x: Mapping[str, torch.Tensor], generator: Optional[torch.Generator] = None) -> torch.Tensor:
        input_wide = self.EmbeddingCollection_0(x, self.wide_features, squeeze_dim=True)
        input_deep = self.EmbeddingCollection_0(x, self.deep_features, squeeze_dim=True)
        return (self.LR_0(input_wide) + self.MLP_0(input_deep, generator=generator)).squeeze(-1)
