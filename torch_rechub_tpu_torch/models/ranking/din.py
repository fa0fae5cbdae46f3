"""DIN, the Deep Interest Network (KDD'2018, arXiv:1706.06978).

Counterpart of ``torch_rechub_tpu/models/ranking/din.py``: per history
feature an ``ActivationUnit`` scores each position against the target
(``[t, h, t − h, t ⊙ h]`` through an MLP) and pools the history by those
scores; the interests, the targets and the profile features feed a Dice MLP.

As in the JAX package the attention MLP sees every position, PAD ones
included: their embeddings are zero through ``padding_idx``, but the
BatchNorm statistics (over B and L) and Dice count them.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from ...basic.layers import MLP
from ...ops.embedding import EmbeddingCollection


class ActivationUnit(nn.Module):
    """Target attention over ``history (B, L, D)`` for ``target (B, D)``: the pooled interest ``(B, D)``."""

    def __init__(self, emb_dim: int, dims: Tuple[int, ...] = (36,), activation: str = "dice", use_softmax: bool = False, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.use_softmax = use_softmax
        self.MLP_0 = MLP(4 * emb_dim, dims, activation=activation, generator=generator, device=device)

    def forward(self, history: torch.Tensor, target: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        t = target[:, None, :].expand_as(history)
        att_weight = self.MLP_0(torch.cat([t, history, t - history, t * history], dim=-1), generator=generator)[..., 0]  # (B, L)
        if self.use_softmax:
            att_weight = torch.softmax(att_weight, dim=-1)
        return torch.einsum("bl,bld->bd", att_weight, history)


def embedded_width(features: Sequence) -> int:
    """Width of the flat ``(B, F, D)`` stack of ``features`` (their dense features left out, as the collection does)."""
    return sum(f.embed_dim for f in features if hasattr(f, "vocab_size"))


class DIN(nn.Module):
    """``forward(x)`` takes a dict of ``(B,)`` and ``(B, L)`` tensors and returns ``(B,)`` logits."""

    def __init__(self, features: Sequence, history_features: Sequence, target_features: Sequence, mlp_params: Dict[str, Any], attention_mlp_params: Dict[str, Any], generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.features, self.history_features, self.target_features = tuple(features), tuple(history_features), tuple(target_features)
        self.EmbeddingCollection_0 = EmbeddingCollection(self.features + self.history_features + self.target_features, generator=generator, device=device)
        for i, fea in enumerate(self.history_features):
            self.add_module(f"ActivationUnit_{i}", ActivationUnit(fea.embed_dim, **attention_mlp_params, generator=generator, device=device))
        width = embedded_width(self.history_features) + embedded_width(self.target_features) + embedded_width(self.features)
        self.MLP_0 = MLP(width, activation="dice", **mlp_params, generator=generator, device=device)

    def forward(self, x: Mapping[str, torch.Tensor], generator: Optional[torch.Generator] = None) -> torch.Tensor:
        embedding = self.EmbeddingCollection_0
        embed_features = embedding(x, self.features)  # (B, F, D)
        embed_history = embedding(x, self.history_features)  # (B, H, L, D)
        embed_target = embedding(x, self.target_features)  # (B, H, D)
        interest = torch.stack([getattr(self, f"ActivationUnit_{i}")(embed_history[:, i], embed_target[:, i], generator=generator) for i in range(len(self.history_features))], dim=1)
        b = interest.shape[0]
        mlp_in = torch.cat([interest.reshape(b, -1), embed_target.reshape(b, -1), embed_features.reshape(b, -1)], dim=1)
        return self.MLP_0(mlp_in, generator=generator).squeeze(-1)
