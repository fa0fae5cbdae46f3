"""NARM (arXiv:1711.04725), neural attentive session-based recommendation.

Counterpart of ``torch_rechub_tpu/models/matching/narm.py``: a masked GRU
over the session; the global representation is the last valid state, the
local one an attention-weighted sum of the states; both through the
bilinear ``b`` to the item space.  Scores against the whole item table, or
two-tower through ``item_feature``.  As in the JAX package the attention is
an unnormalised ``exp(q)`` over the valid steps divided by its sum (no
softmax's max subtraction).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...basic.hstu import dropout
from ...basic.initializers import normal, param
from ...ops.rnn import GRULayer


def _item_table(fea, generator, device) -> nn.Parameter:
    w = fea.initializer((fea.vocab_size, fea.embed_dim), generator)
    w[0] = 0.0
    return nn.Parameter(w.to(device))


class NARM(nn.Module):
    def __init__(self, item_history_feature, hidden_dim: int, emb_dropout_p: float, session_rep_dropout_p: float, item_feature=None, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        fea = item_history_feature
        self.item_history_feature, self.item_feature = fea, item_feature
        self.emb_dropout_p, self.session_rep_dropout_p = emb_dropout_p, session_rep_dropout_p
        self.item_embedding = _item_table(fea, generator, device)
        self.gru = GRULayer(fea.embed_dim, hidden_dim, generator=generator, device=device)
        self.a_1 = param(normal(1.0), (hidden_dim, hidden_dim), generator, device)
        self.a_2 = param(normal(1.0), (hidden_dim, hidden_dim), generator, device)
        self.v = param(normal(1.0), (hidden_dim, 1), generator, device)
        self.b = param(normal(1.0), (fea.embed_dim, 2 * hidden_dim), generator, device)

    def _session_repr(self, x, generator=None) -> torch.Tensor:
        ids = x[self.item_history_feature.name].to(torch.int64)
        mask = (ids != 0).to(torch.float32)
        embs = dropout(self.item_embedding[ids] * mask[..., None], self.emb_dropout_p, self.training, generator)
        h, h_t = self.gru(embs, mask)  # outputs 0 at PAD steps; h_t the last valid state
        q = torch.sigmoid(h_t[:, None, :] @ self.a_1.T + h @ self.a_2.T) @ self.v  # (B, L, 1)
        alpha = torch.exp(q) * mask[..., None]
        alpha = alpha / torch.clamp_min(alpha.sum(1, keepdim=True), 1e-12)
        c = torch.cat([h_t, (alpha * h).sum(1)], dim=-1)
        return dropout(c, self.session_rep_dropout_p, self.training, generator)

    def user_tower(self, x, generator=None, keep_dim: bool = False):
        user = self._session_repr(x, generator) @ self.b.T
        return user[:, None, :] if keep_dim else user

    def item_tower(self, x, generator=None, keep_dim: bool = False):
        if self.item_feature is None:
            return None
        emb = self.item_embedding[x[self.item_feature.name].to(torch.int64)]
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
        return self._session_repr(x, generator) @ self.b.T @ self.item_embedding.T  # scores over every item (B, V)
