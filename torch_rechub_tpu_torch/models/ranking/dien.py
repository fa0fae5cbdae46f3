"""DIEN, the Deep Interest Evolution Network (AAAI'2019, arXiv:1809.03672).

Counterpart of ``torch_rechub_tpu/models/ranking/dien.py``: per history
feature, a GRU interest extractor (``ops/rnn.py``, masked) with an
auxiliary next-step positive / negative BCE, then an attentional AUGRU
interest-evolution layer conditioned on the target.  ``forward`` returns
``(logits, alpha · aux_loss)``: train with ``CTRTrainer(loss_mode=False)``.

The JAX package runs both recurrences as ``lax.scan``s; here each is a
Python loop over the L steps, with every step's input-side products taken
for all steps at once before the loop.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from ...basic.initializers import param, xavier_uniform
from ...basic.layers import MLP
from ...basic.precision import einsum
from ...ops.embedding import EmbeddingCollection, feature_mask, squeeze_width
from ...ops.rnn import GRULayer
from .din import embedded_width


class AUGRU(nn.Module):
    """The attentional-update-gate GRU (the paper's Eq. 14-16) over ``seq (B, L, d)``.

    The attention is a softmax over the valid steps of ``(x Wa) · item``;
    each step's score scales the update gate.  PAD steps score ``-1e9`` (not
    ``-inf``), so an all-PAD row has uniform attention and no NaN in either
    direction; its final state is zero.
    """

    def __init__(self, embed_dim: int, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        d = embed_dim
        for name, shape in (("Wa", (d, d)), ("Wu", (d, d)), ("Uu", (d, d)), ("bu", (1, d)), ("Wr", (d, d)), ("Ur", (d, d)), ("br", (1, d)),
                            ("Wh", (d, d)), ("Uh", (d, d)), ("bh", (1, d))):
            self.register_parameter(name, param(xavier_uniform, shape, generator, device))

    def forward(self, seq: torch.Tensor, item: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        scores = einsum("btd,bd->bt", seq @ self.Wa, item)
        attn = torch.softmax(torch.where(mask > 0, scores, -1e9), dim=1)
        all_pad = mask.sum(1) == 0
        d = self.Wa.shape[0]
        xu, xr, xh = (seq @ torch.cat([self.Wu, self.Wr, self.Wh], dim=1)).split(d, dim=-1)  # (B, L, d) each
        hidden = torch.cat([self.Uu, self.Ur, self.Uh], dim=1)
        h = seq.new_zeros(seq.shape[0], d)
        for t in range(seq.shape[1]):
            hu, hr, hh = (h @ hidden).split(d, dim=-1)
            u = torch.sigmoid(xu[:, t] + hu + self.bu)
            r = torch.sigmoid(xr[:, t] + hr + self.br)
            h_hat = torch.tanh(xh[:, t] + r * hh + self.bh)
            u_hat = attn[:, t, None] * u
            h = (1 - u_hat) * h + u_hat * h_hat
        return torch.where(all_pad[:, None], 0.0, h)


def _auxiliary_loss(outs: torch.Tensor, pos_emb: torch.Tensor, neg_emb: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Next-step positive / negative BCE over the valid adjacent pairs, divided by ``max(Σvalid, 1)``."""
    h = outs[:, :-1]
    valid = (mask[:, :-1] * mask[:, 1:]).reshape(-1)
    pos_logit = (h * pos_emb[:, 1:]).sum(-1).reshape(-1)
    neg_logit = (h * neg_emb[:, 1:]).sum(-1).reshape(-1)
    # BCE(sigmoid(l), 1) + BCE(sigmoid(l), 0), the stable form
    pos_loss = torch.clamp_min(pos_logit, 0) - pos_logit + torch.log1p(torch.exp(-pos_logit.abs()))
    neg_loss = torch.clamp_min(neg_logit, 0) + torch.log1p(torch.exp(-neg_logit.abs()))
    return ((pos_loss + neg_loss) * valid).sum() / torch.clamp_min(valid.sum(), 1.0)


class DIEN(nn.Module):
    """``forward(x)`` takes a dict of ``(B,)`` and ``(B, L)`` tensors and returns ``((B,) logits, alpha · aux_loss)``."""

    def __init__(self, features: Sequence, history_features: Sequence, neg_history_features: Sequence, target_features: Sequence, mlp_params: Dict[str, Any], alpha: float = 0.2, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.features, self.history_features = tuple(features), tuple(history_features)
        self.neg_history_features, self.target_features = tuple(neg_history_features), tuple(target_features)
        self.alpha = alpha
        self.EmbeddingCollection_0 = EmbeddingCollection(self.features + self.history_features + self.neg_history_features + self.target_features, generator=generator, device=device)
        for i, fea in enumerate(self.history_features):
            self.add_module(f"GRULayer_{i}", GRULayer(fea.embed_dim, fea.embed_dim, generator=generator, device=device))
            self.add_module(f"AUGRU_{i}", AUGRU(fea.embed_dim, generator, device))
        width = embedded_width(self.history_features) + embedded_width(self.target_features) + (squeeze_width(self.features) if self.features else 0)
        self.MLP_0 = MLP(width, activation="dice", **mlp_params, generator=generator, device=device)

    def forward(self, x: Mapping[str, torch.Tensor], generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        embedding = self.EmbeddingCollection_0
        embed_history = embedding(x, self.history_features)  # (B, H, L, D)
        embed_neg = embedding(x, self.neg_history_features)
        embed_target = embedding(x, self.target_features)  # (B, H, D)
        aux_loss, evolved = 0.0, []
        for i, fea in enumerate(self.history_features):
            seq, mask = embed_history[:, i], feature_mask(x, fea)
            outs, _ = getattr(self, f"GRULayer_{i}")(seq, mask)
            aux_loss = aux_loss + _auxiliary_loss(outs, seq, embed_neg[:, i], mask)
            evolved.append(getattr(self, f"AUGRU_{i}")(outs, embed_target[:, i], mask))
        b = embed_target.shape[0]
        parts = [torch.stack(evolved, dim=1).reshape(b, -1), embed_target.reshape(b, -1)]
        if self.features:
            parts.append(embedding(x, self.features, squeeze_dim=True))
        return self.MLP_0(torch.cat(parts, dim=1), generator=generator).squeeze(-1), self.alpha * aux_loss
