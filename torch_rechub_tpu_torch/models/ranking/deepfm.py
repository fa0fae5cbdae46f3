"""DeepFM (IJCAI'2017, arXiv:1703.04247).

Counterpart of ``torch_rechub_tpu/models/ranking/deepfm.py``: first-order
LR and second-order FM over the fm features, an MLP over the deep
features, summed into one logit per example.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from ...basic.layers import FM, LR, MLP
from ...ops.embedding import EmbeddingCollection, squeeze_width


class DeepFM(nn.Module):
    """``forward(x)`` takes a dict of ``(B,)`` tensors and returns ``(B,)`` logits.

    The fm features share one embed_dim.  LR reads their flattened
    ``(B, F·D)`` embeddings, FM the ``(B, F, D)`` stack, the MLP the flat
    deep features.  The table layout is the process default
    (``ops.embedding.set_fused_default``).  Submodules carry flax's names
    (``EmbeddingCollection_0``, ``LR_0``, ``MLP_0``), so a flax DeepFM's
    variables load by name.
    """

    def __init__(self, deep_features: Sequence, fm_features: Sequence, mlp_params: Dict[str, Any], generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.deep_features, self.fm_features = tuple(deep_features), tuple(fm_features)
        self.EmbeddingCollection_0 = EmbeddingCollection(self.deep_features + self.fm_features, generator=generator, device=device)
        self.LR_0 = LR(squeeze_width(self.fm_features), generator=generator, device=device)
        self.FM_0 = FM(reduce_sum=True)
        self.MLP_0 = MLP(squeeze_width(self.deep_features), **mlp_params, generator=generator, device=device)

    def forward(self, x: Mapping[str, torch.Tensor], generator: Optional[torch.Generator] = None) -> torch.Tensor:
        input_deep = self.EmbeddingCollection_0(x, self.deep_features, squeeze_dim=True)  # (B, ΣD)
        input_fm = self.EmbeddingCollection_0(x, self.fm_features)  # (B, F, D)
        y_linear = self.LR_0(input_fm.reshape(input_fm.shape[0], -1))
        y_fm = self.FM_0(input_fm)
        y_deep = self.MLP_0(input_deep, generator=generator)
        return (y_linear + y_fm + y_deep).squeeze(-1)
