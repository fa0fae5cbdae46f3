"""SASRec (ICDM'2018, arXiv:1808.09781), self-attentive sequential recommendation.

Counterpart of ``torch_rechub_tpu/models/matching/sasrec.py``: a causal
transformer over the item sequence.  Each block attends from
``LayerNorm(h)`` to the un-normed ``h`` (flax's attention with separate
query and key/value inputs, ``basic/attention.py``), adds the normed query
back, normalises again and runs the point-wise feed-forward; every
``LayerNorm`` takes eps 1e-8.  ``forward`` returns ``(pos_logits,
neg_logits)`` per position over aligned positive / negative sequences, or
with ``item_feature`` the two-tower score, the user being the last valid
position's output.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...basic.attention import LayerNorm, MultiHeadDotProductAttention
from ...basic.features import table_name
from ...basic.hstu import dropout
from ...basic.initializers import linear, normal, param
from ...ops.embedding import EmbeddingCollection


class PointWiseFeedForward(nn.Module):
    def __init__(self, hidden: int, dropout_rate: float, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.Dense_0 = linear(hidden, hidden, generator, device)
        self.Dense_1 = linear(hidden, hidden, generator, device)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        drop = lambda t: dropout(t, self.dropout_rate, self.training, generator)  # noqa: E731
        return drop(self.Dense_1(F.relu(drop(self.Dense_0(x))))) + x


class SASRec(nn.Module):
    def __init__(self, features: Sequence, max_len: int = 50, dropout_rate: float = 0.5, num_blocks: int = 2, num_heads: int = 1, item_feature=None, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.features, self.item_feature = tuple(features), item_feature  # (seq, pos, neg) sharing one table
        self.max_len, self.dropout_rate, self.num_blocks = max_len, dropout_rate, num_blocks
        self.item_emb = EmbeddingCollection(self.features + ((item_feature,) if item_feature is not None else ()), generator=generator, device=device)
        d = self.features[0].embed_dim
        self.position_emb = param(normal(1.0), (max_len, d), generator, device)
        for i in range(num_blocks):  # flax names lists of submodules attn_lns_{i}, attns_{i}, ...
            self.add_module(f"attn_lns_{i}", LayerNorm(d, eps=1e-8, device=device))
            self.add_module(f"attns_{i}", MultiHeadDotProductAttention(d, num_heads, dropout_rate, generator, device))
            self.add_module(f"fwd_lns_{i}", LayerNorm(d, eps=1e-8, device=device))
            self.add_module(f"fwds_{i}", PointWiseFeedForward(d, dropout_rate, generator, device))
        self.last_ln = LayerNorm(d, eps=1e-8, device=device)

    def seq_forward(self, x, embed_seq: torch.Tensor, generator=None) -> torch.Tensor:
        seq_ids = x[self.features[0].name]
        l, d = seq_ids.shape[1], self.features[0].embed_dim
        h = dropout(embed_seq * d**0.5 + self.position_emb[None, :l, :], self.dropout_rate, self.training, generator)
        valid = (seq_ids != 0)[..., None].to(h.dtype)
        h = h * valid
        causal = torch.tril(torch.ones(l, l, dtype=torch.bool, device=h.device))[None, None]
        for i in range(self.num_blocks):
            q = getattr(self, f"attn_lns_{i}")(h)
            h = q + getattr(self, f"attns_{i}")(q, mask=causal, generator=generator, inputs_kv=h)
            h = getattr(self, f"fwds_{i}")(getattr(self, f"fwd_lns_{i}")(h), generator) * valid
        return self.last_ln(h)

    def user_tower(self, x, generator=None, keep_dim: bool = False):
        out = self.seq_forward(x, self.item_emb(x, self.features[:1])[:, 0], generator)
        last = torch.clamp_min((x[self.features[0].name] != 0).sum(1) - 1, 0)
        user = out[torch.arange(out.shape[0], device=out.device), last]
        return user[:, None, :] if keep_dim else user

    def item_tower(self, x, generator=None, keep_dim: bool = False):
        if self.item_feature is None:
            return None
        emb = self.item_emb.table(table_name(self.item_feature))[x[self.item_feature.name].to(torch.int64)]
        return emb[:, None, :] if keep_dim else emb

    def towers(self, x, generator=None):
        return self.user_tower(x, generator), self.item_tower(x, generator)

    def forward(self, x, mode=None, generator=None):
        if mode == "user":
            return self.user_tower(x, generator)
        if mode == "item":
            return self.item_tower(x, generator)
        if self.item_feature is not None:
            return (self.user_tower(x, generator) * self.item_tower(x, generator)).sum(-1)
        embedding = self.item_emb(x, self.features)  # (B, 3, L, D)
        out = self.seq_forward(x, embedding[:, 0], generator)
        return (out * embedding[:, 1]).sum(-1), (out * embedding[:, 2]).sum(-1)
