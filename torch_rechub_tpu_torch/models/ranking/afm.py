"""AFM, the Attentional Factorization Machine (IJCAI'2017, arXiv:1708.04617).

Counterpart of ``torch_rechub_tpu/models/ranking/afm.py``: LR over the flat
embeddings plus the FM's ``(B, D)`` interaction weighted by an attention
head ``softmax(relu(W y_fm) h)`` and projected through ``p``.

As in the JAX package, the softmax runs over an axis of size 1, so the
attention is 1 for every row: ``Dense_0`` and ``h`` take a zero gradient.
The port mirrors that rather than add what the reference lacks.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...basic.initializers import linear, param, xavier_uniform
from ...basic.layers import FM, LR
from ...ops.embedding import EmbeddingCollection, squeeze_width


class AFM(nn.Module):
    """``forward(x)`` takes a dict of ``(B,)`` tensors and returns ``(B,)`` logits."""

    def __init__(self, fm_features: Sequence, embed_dim: int, t: int = 64, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.fm_features = tuple(fm_features)
        self.EmbeddingCollection_0 = EmbeddingCollection(self.fm_features, generator=generator, device=device)
        self.LR_0 = LR(squeeze_width(self.fm_features), generator=generator, device=device)
        self.FM_0 = FM(reduce_sum=False)
        self.Dense_0 = linear(embed_dim, t, generator, device)
        self.h = param(xavier_uniform, (t, 1), generator, device)
        self.p = param(xavier_uniform, (embed_dim, 1), generator, device)

    def forward(self, x: Mapping[str, torch.Tensor], generator: Optional[torch.Generator] = None) -> torch.Tensor:
        input_fm = self.EmbeddingCollection_0(x, self.fm_features)  # (B, F, D)
        y_linear = self.LR_0(input_fm.reshape(input_fm.shape[0], -1))
        y_fm = self.FM_0(input_fm)  # (B, D)
        atts = torch.softmax(F.relu(self.Dense_0(y_fm)) @ self.h, dim=1)  # (B, 1): identically 1
        return (y_linear + (atts * y_fm) @ self.p).squeeze(-1)
