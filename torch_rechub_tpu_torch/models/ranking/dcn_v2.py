"""DCN v2 (WWW'21, arXiv:2008.13535).

Counterpart of ``torch_rechub_tpu/models/ranking/dcn_v2.py``: a
``CrossNetV2`` or ``CrossNetMix`` core in a ``crossnet_only``, ``stacked``
or ``parallel`` structure, then LR.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from ...basic.layers import LR, MLP, CrossNetMix, CrossNetV2, mlp_width
from ...ops.embedding import EmbeddingCollection, squeeze_width


class DCNv2(nn.Module):
    """``forward(x)`` takes a dict of ``(B,)`` tensors and returns ``(B,)`` logits."""

    def __init__(self, features: Sequence, n_cross_layers: int, mlp_params: Dict[str, Any], model_structure: str = "parallel", use_low_rank_mixture: bool = True, low_rank: int = 32, num_experts: int = 4, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if model_structure not in ("crossnet_only", "stacked", "parallel"):
            raise ValueError(f"model_structure={model_structure} not supported!")
        self.features, self.model_structure = tuple(features), model_structure
        d = squeeze_width(self.features)
        self.EmbeddingCollection_0 = EmbeddingCollection(self.features, generator=generator, device=device)
        if use_low_rank_mixture:
            self.CrossNetMix_0 = CrossNetMix(d, n_cross_layers, low_rank, num_experts, generator, device)
        else:
            self.CrossNetV2_0 = CrossNetV2(d, n_cross_layers, generator, device)
        self.cross_name = "CrossNetMix_0" if use_low_rank_mixture else "CrossNetV2_0"
        width = d
        if model_structure != "crossnet_only":
            self.MLP_0 = MLP(d, output_layer=False, **mlp_params, generator=generator, device=device)
            width = mlp_width(d, mlp_params) + (d if model_structure == "parallel" else 0)
        self.LR_0 = LR(width, generator=generator, device=device)

    def forward(self, x: Mapping[str, torch.Tensor], generator: Optional[torch.Generator] = None) -> torch.Tensor:
        embed_x = self.EmbeddingCollection_0(x, self.features, squeeze_dim=True)
        cross_out = getattr(self, self.cross_name)(embed_x)
        if self.model_structure == "crossnet_only":
            final_out = cross_out
        elif self.model_structure == "stacked":
            final_out = self.MLP_0(cross_out, generator=generator)
        else:
            final_out = torch.cat([cross_out, self.MLP_0(embed_x, generator=generator)], dim=1)
        return self.LR_0(final_out).squeeze(-1)
