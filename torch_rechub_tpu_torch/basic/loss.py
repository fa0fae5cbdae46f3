"""Losses and regularization.

Counterpart of ``torch_rechub_tpu/basic/loss.py``: ``bce_with_logits``,
``mse_loss``, the list-wise ``softmax_cross_entropy`` and the pair-wise
``bpr_loss`` and ``hinge_loss`` (WARP-weighted with ``num_items``) with a
per-example weight (a padded batch's padding rows weigh 0), computed in
float32; ``nce_loss`` and ``in_batch_nce_loss``, temperature-scaled
cross-entropy that ignores a target id; ``classify_param`` and ``RegularizationLoss``,
which sort parameters by name into normalisation (exempt), embedding and
dense.  The port's ``state_dict`` names keep the words that sort them
(``EmbeddingCollection``, ``_table``, ``BatchNorm``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

import torch

from ..parallel.distributed import mean_over_batch, mean_over_data


def _weighted_mean(loss: torch.Tensor, weight: Optional[torch.Tensor]) -> torch.Tensor:
    """``Σ w·ℓ / max(Σ w, 1e-12)`` (the plain mean without weights); inside a step under a device mesh, the global
    batch's (``parallel.distributed.mean_over_data``)."""
    if weight is None:
        return mean_over_batch(loss)
    weight = weight.to(loss.dtype)
    return mean_over_data((loss * weight).sum(), weight.sum(), 1e-12)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor, weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Binary cross-entropy from logits, ``Σ w·ℓ / max(Σ w, 1e-12)``, in float32."""
    logits = logits.reshape(targets.shape).to(torch.float32)
    targets = targets.to(logits.dtype)
    loss = torch.clamp_min(logits, 0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    return _weighted_mean(loss, weight)


def mse_loss(preds: torch.Tensor, targets: torch.Tensor, weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    preds = preds.reshape(targets.shape).to(torch.float32)
    return _weighted_mean((preds - targets.to(preds.dtype)) ** 2, weight)


def softmax_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-entropy over the last axis with integer ``targets`` (the list-wise matching mode)."""
    log_probs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(log_probs, -1, targets[..., None].to(torch.int64))[..., 0]
    return _weighted_mean(nll, weight)


def bpr_loss(pos_score: torch.Tensor, neg_score: torch.Tensor, weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bayesian personalised ranking, ``-log sigmoid(pos - neg)``, in three shape cases.

    Equal shapes compare element by element (SASRec's per-position
    logits); otherwise ``pos`` is flattened to ``(B,)`` and a 1-D ``neg``
    compares element by element, a 2-D ``neg (B, K)`` against
    ``pos[:, None]``.  ``weight`` is per sample (the leading axis) and is
    broadcast over the other axes of the difference, so the mean counts
    every position of a weighted sample, PAD positions of a sequence too.
    """
    pos_score, neg_score = pos_score.to(torch.float32), neg_score.to(torch.float32)
    if pos_score.shape == neg_score.shape:
        diff = pos_score - neg_score
        if weight is not None and diff.ndim > 1:
            weight = weight.reshape(weight.shape[0], *([1] * (diff.ndim - 1))).expand(diff.shape)
    else:
        pos_score = pos_score.reshape(-1)
        if neg_score.ndim == 1:
            diff = pos_score - neg_score
        else:
            diff = pos_score[:, None] - neg_score
            if weight is not None:
                weight = weight[:, None].expand(diff.shape)
    return _weighted_mean(-torch.nn.functional.logsigmoid(diff), weight)


def hinge_loss(pos_score: torch.Tensor, neg_score: torch.Tensor, margin: float = 2.0, num_items: Optional[int] = None, weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pair-wise hinge ``max(max_j neg_j − pos + margin, 0)``; with ``num_items``, WARP's weight ``log(rank + 1)``,
    the rank the share of negatives within the margin times ``num_items``."""
    pos_score = pos_score.reshape(-1).to(torch.float32)
    neg_score = neg_score.to(torch.float32)
    neg_2d = neg_score if neg_score.ndim > 1 else neg_score[:, None]
    loss = torch.clamp_min(torch.amax(neg_2d, dim=-1) - pos_score + margin, 0.0)
    if num_items is not None:
        impostors = (neg_2d - pos_score[:, None] + margin) > 0
        rank = impostors.to(loss.dtype).mean(dim=-1) * num_items
        loss = loss * torch.log(rank + 1.0)
    return _weighted_mean(loss, weight)


def nce_loss(logits: torch.Tensor, targets: torch.Tensor, temperature: float = 1.0, ignore_index: int = 0, reduction: str = "mean") -> torch.Tensor:
    """Temperature-scaled cross-entropy over the last axis; targets equal to ``ignore_index`` count for nothing.
    ``reduction``: ``"mean"`` over the counted targets, ``"sum"``, or ``"none"`` (the masked per-target losses)."""
    log_probs = torch.log_softmax(logits.to(torch.float32) / temperature, dim=-1)
    nll = -torch.gather(log_probs, -1, targets[..., None].to(torch.int64))[..., 0]
    mask = (targets != ignore_index).to(nll.dtype)
    if reduction == "none":
        return nll * mask
    if reduction == "sum":
        return torch.sum(nll * mask)
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def in_batch_nce_loss(embeddings: torch.Tensor, item_embeddings: torch.Tensor, targets: torch.Tensor, temperature: float = 0.1, ignore_index: int = 0, reduction: str = "mean") -> torch.Tensor:
    """User-against-every-item NCE: :func:`nce_loss` of ``embeddings @ item_embeddings.T``."""
    return nce_loss(embeddings @ item_embeddings.T, targets, temperature=temperature, ignore_index=ignore_index, reduction=reduction)


_NORM_MARKERS = ("batchnorm", "layernorm", "groupnorm", "instancenorm", "_norm")
_EMBED_MARKERS = ("embedding", "embed_table", "tables")


def classify_param(name: str) -> str:
    """``'norm' | 'embedding' | 'dense'`` by the parameter's name, as the JAX package sorts flax paths."""
    p = name.lower()
    if any(m in p for m in _NORM_MARKERS):
        return "norm"
    if any(m in p for m in _EMBED_MARKERS):
        return "embedding"
    return "dense"


@dataclasses.dataclass(frozen=True)
class RegularizationLoss:
    """L1 / L2 regularization with separate embedding and dense coefficients."""

    embedding_l1: float = 0.0
    embedding_l2: float = 0.0
    dense_l1: float = 0.0
    dense_l2: float = 0.0

    def __bool__(self):
        return any(c > 0 for c in (self.embedding_l1, self.embedding_l2, self.dense_l1, self.dense_l2))

    def __call__(self, named_parameters: Iterable[Tuple[str, torch.Tensor]]) -> torch.Tensor:
        """The penalty over ``module.named_parameters()``.

        The L1 term's gradient at 0 is 1, as ``jnp.abs``'s is (torch's
        ``abs`` gives 0 there): the zero-initialised biases take the L1
        coefficient on the first step in both packages.
        """
        total = 0.0
        for name, leaf in named_parameters:
            kind = classify_param(name)
            if kind == "norm":
                continue
            l1 = self.embedding_l1 if kind == "embedding" else self.dense_l1
            l2 = self.embedding_l2 if kind == "embedding" else self.dense_l2
            if l1 > 0:
                total = total + l1 * torch.where(leaf >= 0, leaf, -leaf).sum()
            if l2 > 0:
                total = total + l2 * leaf.square().sum()
        return torch.as_tensor(total, dtype=torch.float32)
