"""BST, the Behavior Sequence Transformer (arXiv:1905.06874).

Counterpart of ``torch_rechub_tpu/models/ranking/bst.py``: the history's
item vectors with the target appended as the last step, learned
positions, a post-norm transformer encoder with a LeakyReLU FFN and
key-padding masks; the target position's output is the interest that
feeds the MLP.

The encoder layer follows flax's modules, not ``nn.TransformerEncoderLayer``:
``MultiHeadDotProductAttention`` puts ``1/sqrt(head_dim)`` on the query and
masks keys with ``finfo(float32).min``; its attention dropout is one mask
shared by every row and head; ``LayerNorm`` normalises by
``E[x²] − E[x]²`` (both in ``basic/attention.py``, which SASRec shares).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...basic.attention import LayerNorm, MultiHeadDotProductAttention
from ...basic.hstu import dropout
from ...basic.initializers import linear, normal, param
from ...basic.layers import MLP
from ...ops.embedding import EmbeddingCollection, squeeze_width
from .din import embedded_width


class TransformerEncoderLayer(nn.Module):
    """Post-norm self-attention and FFN block; ``key_padding_mask (B, L)`` is True at PAD keys."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048, dropout: float = 0.1, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.dropout = dropout
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(d_model, nhead, dropout, generator, device)
        self.LayerNorm_0 = LayerNorm(d_model, device=device)
        self.Dense_0 = linear(d_model, dim_feedforward, generator, device)
        self.Dense_1 = linear(dim_feedforward, d_model, generator, device)
        self.LayerNorm_1 = LayerNorm(d_model, device=device)

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        mask = None if key_padding_mask is None else ~key_padding_mask[:, None, None, :]
        drop = lambda t: dropout(t, self.dropout, self.training, generator)  # noqa: E731
        attn = self.MultiHeadDotProductAttention_0(x, mask=mask, generator=generator)
        x = self.LayerNorm_0(x + drop(attn))
        ff = self.Dense_1(drop(F.leaky_relu(self.Dense_0(x), negative_slope=0.01)))
        return self.LayerNorm_1(x + drop(ff))


class BST(nn.Module):
    """``forward(x)`` takes a dict of ``(B,)`` and ``(B, L)`` tensors and returns ``(B,)`` logits."""

    def __init__(self, features: Sequence, history_features: Sequence, target_features: Sequence, mlp_params: Dict[str, Any], nhead: int = 8, dropout: float = 0.2, num_layers: int = 1, max_seq_len: int = 51, dim_feedforward: int = 2048, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.features, self.history_features, self.target_features = tuple(features), tuple(history_features), tuple(target_features)
        item_dim, target_dim = embedded_width(self.history_features), embedded_width(self.target_features)
        if item_dim != target_dim:
            raise ValueError(f"sum of history embed_dim ({item_dim}) must equal target embed_dim ({target_dim})")
        if item_dim % nhead != 0:
            raise ValueError(f"item_dim ({item_dim}) must be divisible by nhead ({nhead})")
        self.num_layers, self.max_seq_len = num_layers, max_seq_len
        self.EmbeddingCollection_0 = EmbeddingCollection(self.features + self.history_features + self.target_features, generator=generator, device=device)
        self.pos_embedding = param(normal(1.0), (max_seq_len, item_dim), generator, device)
        for i in range(num_layers):
            self.add_module(f"TransformerEncoderLayer_{i}", TransformerEncoderLayer(item_dim, nhead, dim_feedforward, dropout, generator, device))
        width = item_dim + target_dim + (squeeze_width(self.features) if self.features else 0)
        self.MLP_0 = MLP(width, **mlp_params, generator=generator, device=device)

    def forward(self, x: Mapping[str, torch.Tensor], generator: Optional[torch.Generator] = None) -> torch.Tensor:
        embedding = self.EmbeddingCollection_0
        embed_history = embedding(x, self.history_features)  # (B, H, L, D)
        embed_target = embedding(x, self.target_features)  # (B, K, D)
        b, n_hist, seq_len, _ = embed_history.shape
        hist = torch.cat([embed_history[:, i] for i in range(n_hist)], dim=-1)  # (B, L, item_dim)
        tgt = torch.cat([embed_target[:, i] for i in range(embed_target.shape[1])], dim=-1)  # (B, item_dim)
        seq = torch.cat([hist, tgt[:, None, :]], dim=1)  # (B, L + 1, item_dim)
        if seq.shape[1] > self.max_seq_len:
            raise ValueError(f"sequence length {seq.shape[1]} exceeds max_seq_len {self.max_seq_len}")
        seq = seq + self.pos_embedding[None, : seq.shape[1], :]

        # a position is PAD only if every history feature is padding there
        pad = torch.ones(b, seq_len, dtype=torch.bool, device=seq.device)
        for fea in self.history_features:
            pad = pad & (x[fea.name] == (fea.padding_idx if fea.padding_idx is not None else 0))
        key_padding = torch.cat([pad, torch.zeros(b, 1, dtype=torch.bool, device=seq.device)], dim=1)

        out = seq
        for i in range(self.num_layers):
            out = getattr(self, f"TransformerEncoderLayer_{i}")(out, key_padding, generator)
        parts = [out[:, -1, :], embed_target.reshape(b, -1)]
        if self.features:
            parts.append(embedding(x, self.features, squeeze_dim=True))
        return self.MLP_0(torch.cat(parts, dim=1), generator=generator).squeeze(-1)
