"""STAMP (KDD'2018), short-term attention / memory priority.

Counterpart of ``torch_rechub_tpu/models/matching/stamp.py``: attention over
the session's items conditioned on the last click ``x_t`` and the session
mean ``m_s``; the user is ``h_s ⊙ h_t``.  Scores against the whole item
table, or two-tower through ``item_feature``.  As in the JAX package the
last click is position ``count − 1`` (post-padded sessions).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...basic.initializers import normal, param, zeros


class STAMP(nn.Module):
    def __init__(self, item_history_feature, weight_std: float, emb_std: float, item_feature=None, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.item_history_feature, self.item_feature = item_history_feature, item_feature
        d = item_history_feature.embed_dim
        self.item_embedding = param(normal(emb_std), (item_history_feature.vocab_size, d), generator, device)
        self.w_0 = param(normal(weight_std), (d, 1), generator, device)
        self.w_1_t = param(normal(weight_std), (d, d), generator, device)
        self.w_2_t = param(normal(weight_std), (d, d), generator, device)
        self.w_3_t = param(normal(weight_std), (d, d), generator, device)
        self.b_a = param(zeros, (d,), device=device)
        for name in ("f_s", "f_t"):  # flax Dense with a normal(emb_std) kernel and a zero bias
            layer = nn.Linear(d, d, device=device)
            with torch.no_grad():
                layer.weight.copy_(normal(emb_std)((d, d), generator).T)
                layer.bias.zero_()
            self.add_module(name, layer)

    def _user_repr(self, x) -> torch.Tensor:
        ids = x[self.item_history_feature.name].to(torch.int64)
        mask = (ids != 0)[..., None]  # (B, L, 1)
        counts = torch.clamp_min(mask.sum(1), 1)  # (B, 1)
        embs = self.item_embedding[ids] * mask
        x_t = self.item_embedding[torch.gather(ids, 1, counts - 1)]  # (B, 1, D)
        m_s = (embs.sum(1) / counts)[:, None, :]  # (B, 1, D)
        gate = torch.sigmoid(embs @ self.w_1_t + x_t @ self.w_2_t + m_s @ self.w_3_t + self.b_a)
        a = torch.exp(gate @ self.w_0) * mask  # (B, L, 1)
        a = a / torch.clamp_min(a.abs().sum(1, keepdim=True), 1e-12)  # L1 normalised
        m_a = (a * embs).sum(1) + m_s[:, 0]
        return self.f_s(torch.tanh(m_a)) * self.f_t(torch.tanh(x_t))[:, 0]

    def user_tower(self, x, generator=None, keep_dim: bool = False):
        user = self._user_repr(x)
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
            return (self.user_tower(x) * self.item_tower(x)).sum(-1)
        return self._user_repr(x) @ self.item_embedding.T
