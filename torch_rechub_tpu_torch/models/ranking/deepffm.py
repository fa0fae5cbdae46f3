"""DeepFFM and FAT-DeepFFM (arXiv:1905.06336).

Counterpart of ``torch_rechub_tpu/models/ranking/deepffm.py``: field-aware
embeddings by the id-offset trick (``id · F + field``, so each cross
feature's table is declared with ``vocab · F`` rows), FFM's pairwise
crosses into an MLP; FAT adds CEN's attention over the crosses.  The
linear term sums the 1-dim embeddings of the ``linear_embedding``
collection; the crosses read the ``ffm_embedding`` collection.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from ...basic.initializers import param, zeros
from ...basic.layers import CEN, FFM, MLP
from ...ops.embedding import EmbeddingCollection


class _FFMParts(nn.Module):
    """What both models share: the two collections, FFM's crosses and the bias ``b``."""

    def __init__(self, linear_features: Sequence, cross_features: Sequence, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.linear_features, self.cross_features = tuple(linear_features), tuple(cross_features)
        self.num_fields = len(self.cross_features)
        self.num_crosses = self.num_fields * (self.num_fields - 1) // 2
        self.linear_embedding = EmbeddingCollection(self.linear_features, generator=generator, device=device)
        self.ffm_embedding = EmbeddingCollection(self.cross_features, generator=generator, device=device)
        self.FFM_0 = FFM(self.num_fields, reduce_sum=False, device=device)
        self.b = param(zeros, (1,), device=device)
        self.register_buffer("offset", torch.arange(self.num_fields, dtype=torch.int32, device=device), persistent=False)

    def parts(self, x: Mapping[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(y_linear (B, 1), crosses (B, P, D))``."""
        y_linear = self.linear_embedding(x, self.linear_features, squeeze_dim=True).sum(1, keepdim=True)
        x_ffm = {f.name: x[f.name].to(torch.int32)[:, None] * self.num_fields + self.offset for f in self.cross_features}
        return y_linear, self.FFM_0(self.ffm_embedding(x_ffm, self.cross_features))


class DeepFFM(_FFMParts):
    """``forward(x)`` takes a dict of ``(B,)`` tensors and returns ``(B,)`` logits."""

    def __init__(self, linear_features: Sequence, cross_features: Sequence, embed_dim: int, mlp_params: Dict[str, Any], generator: Optional[torch.Generator] = None, device=None):
        super().__init__(linear_features, cross_features, generator, device)
        self.MLP_0 = MLP(self.num_crosses * embed_dim, **mlp_params, generator=generator, device=device)

    def forward(self, x: Mapping[str, torch.Tensor], generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y_linear, em = self.parts(x)
        y_ffm = self.MLP_0(em.reshape(em.shape[0], -1), generator=generator)
        return (y_linear + y_ffm).squeeze(-1) + self.b


class FatDeepFFM(_FFMParts):
    """``forward(x)`` takes a dict of ``(B,)`` tensors and returns ``(B,)`` logits."""

    def __init__(self, linear_features: Sequence, cross_features: Sequence, embed_dim: int, reduction_ratio: int, mlp_params: Dict[str, Any], generator: Optional[torch.Generator] = None, device=None):
        super().__init__(linear_features, cross_features, generator, device)
        self.CEN_0 = CEN(embed_dim, self.num_crosses, reduction_ratio, generator, device)
        self.MLP_0 = MLP(self.num_crosses * embed_dim, **mlp_params, generator=generator, device=device)

    def forward(self, x: Mapping[str, torch.Tensor], generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y_linear, em = self.parts(x)
        y_ffm = self.MLP_0(self.CEN_0(em, generator=generator), generator=generator)
        return (y_linear + y_ffm).squeeze(-1) + self.b
