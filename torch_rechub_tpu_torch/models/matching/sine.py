"""SINE (arXiv:2102.09267), the sparse-interest network.

Counterpart of ``torch_rechub_tpu/models/matching/sine.py``: a virtual
concept vector by masked self-attention over the history, the top
``num_intention`` of ``num_concept`` prototypes, the intention assignment of
each position, attention per intention, and the adaptive aggregation into
one user vector; all einsums.  ``history_features``, ``item_features`` and
``neg_item_features`` name the inputs (strings), as in the JAX package.

The concept top-k breaks ties as ``jax.lax.top_k`` does, the lower index
first: a stable descending sort, whose first ``num_intention`` columns are
taken.  ``torch.topk`` promises no order among equal scores.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ...basic.initializers import normal, param, uniform
from ...utils.match import stable_topk
from .base import l2_normalize


class SINE(nn.Module):
    def __init__(self, history_features: Sequence[str], item_features: Sequence[str], neg_item_features: Sequence[str], num_items: int, embedding_dim: int, hidden_dim: int, num_concept: int, num_intention: int, seq_max_len: int, num_heads: int = 1, temperature: float = 1.0, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.history_features, self.item_features, self.neg_item_features = tuple(history_features), tuple(item_features), tuple(neg_item_features)
        self.num_intention, self.seq_max_len, self.temperature = num_intention, seq_max_len, temperature
        d, h = embedding_dim, hidden_dim
        for name, shape in (("item_embedding", (num_items, d)), ("concept_embedding", (num_concept, d)), ("position_embedding", (seq_max_len, d))):
            self.register_parameter(name, param(normal(1e-4), shape, generator, device))
        for name, shape in (("w_1", (d, h)), ("w_2", (h, num_heads)), ("w_3", (d, d)), ("w_k1", (d, h)), ("w_k2", (h, num_intention)), ("w_4", (d, h)), ("w_5", (h, num_heads))):
            self.register_parameter(name, param(uniform(1.0), shape, generator, device))

    def user_tower(self, x, generator=None, keep_dim: bool = False):
        hist = x[self.history_features[0]].to(torch.int64)
        x_u = self.item_embedding[hist] + self.position_embedding[None]
        mask = (hist > 0).to(torch.float32)[..., None]  # (B, L, 1)

        # the virtual concept vector z_u, by masked self-attention
        h_1 = torch.tanh(torch.einsum("bse,ed->bsd", x_u, self.w_1))
        a_hist = torch.softmax(torch.einsum("bsd,dh->bsh", h_1, self.w_2) - 1e9 * (1.0 - mask), dim=1)
        z_u = torch.einsum("bse,bsh->be", x_u, a_hist)

        # the top-k concepts
        top_vals, top_idx = stable_topk(z_u @ self.concept_embedding.T, self.num_intention)
        c_u = torch.sigmoid(top_vals)[..., None] * self.concept_embedding[top_idx]  # (B, K, D)

        # the intention assignment P(k|t)
        p_u = torch.softmax(torch.einsum("bse,bke->bks", l2_normalize(x_u @ self.w_3), l2_normalize(c_u)), dim=1)

        # the attention weighting P(t|k)
        h_2 = torch.tanh(torch.einsum("bse,ed->bsd", x_u, self.w_k1))
        a_concept = torch.softmax(torch.einsum("bsd,dk->bsk", h_2, self.w_k2) - 1e9 * (1.0 - mask), dim=1)

        # the multi-interest encoding
        phi_u = torch.einsum("bks,bse->bke", p_u * a_concept.transpose(1, 2), x_u)

        # the adaptive aggregation
        x_u_hat = torch.einsum("bks,bke->bse", p_u, c_u)
        h_3 = torch.tanh(torch.einsum("bse,ed->bsd", x_u_hat, self.w_4))
        agg_logits = torch.einsum("bsd,dh->bsh", h_3, self.w_5).reshape(-1, self.seq_max_len)
        agg = torch.softmax(agg_logits - 1e9 * (1.0 - mask[..., 0]), dim=1)
        c_u_apt = l2_normalize(torch.einsum("bs,bse->be", agg, x_u_hat))
        e_u = torch.softmax(torch.einsum("be,bke->bk", c_u_apt, phi_u) / self.temperature, dim=1)
        v_u = torch.einsum("bk,bke->be", e_u, phi_u)
        return v_u[:, None, :] if keep_dim else v_u

    def item_tower(self, x, generator=None, with_negatives: bool = False):
        pos = self.item_embedding[x[self.item_features[0]].to(torch.int64)][:, None, :]
        if not with_negatives:
            return pos[:, 0, :]
        neg = self.item_embedding[x[self.neg_item_features[0]].to(torch.int64)]
        if neg.ndim == 4:
            neg = neg[:, 0]
        return torch.cat([pos, neg], dim=1)

    def towers(self, x, generator=None):
        return self.user_tower(x, generator), self.item_tower(x, generator)

    def forward(self, x, mode=None, generator=None):
        if mode == "user":
            return self.user_tower(x, generator)
        if mode == "item":
            return self.item_tower(x, generator)
        return (self.user_tower(x, generator, keep_dim=True) * self.item_tower(x, generator, with_negatives=True)).sum(-1)
