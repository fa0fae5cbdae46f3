"""Evaluation metrics.

Counterpart of ``torch_rechub_tpu/basic/metric.py``: the exact tie-aware
AUC on the host (numpy), and the bucketed AUC whose per-batch score
histograms add up on the device, so only one scalar reaches the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def auc_score(y_true, y_pred) -> float:
    """Exact ROC-AUC via average ranks (tie-aware Mann-Whitney)."""
    y_true = np.asarray(y_true).ravel().astype(np.float64)
    y_pred = np.asarray(y_pred).ravel().astype(np.float64)
    n_pos = float(np.sum(y_true > 0))
    n_neg = float(len(y_true) - n_pos)
    if n_pos == 0 or n_neg == 0:
        raise ValueError("AUC undefined: y_true contains a single class")
    order = np.argsort(y_pred, kind="mergesort")
    ranks = np.empty(len(y_pred), dtype=np.float64)
    # average ranks over tied groups (1-based)
    _, inv, counts = np.unique(y_pred[order], return_inverse=True, return_counts=True)
    avg_rank = np.cumsum(counts) - (counts - 1) / 2.0
    ranks[order] = avg_rank[inv]
    pos_rank_sum = np.sum(ranks[y_true > 0])
    return float((pos_rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def auc_histogram(y_true: torch.Tensor, y_score: torch.Tensor, n_bins: int = 65536, lo: float = 0.0, hi: float = 1.0, weight: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos, neg) score histograms of one batch, on the scores' device; histograms of batches add."""
    y_true = y_true.reshape(-1).to(torch.float32)
    s = y_score.reshape(-1).to(torch.float32)
    w = torch.ones_like(y_true) if weight is None else weight.reshape(-1).to(torch.float32)
    bins = torch.clamp(((s - lo) / (hi - lo) * n_bins).to(torch.int64), 0, n_bins - 1)
    pos = torch.zeros(n_bins, dtype=torch.float32, device=s.device).index_add_(0, bins, y_true * w)
    neg = torch.zeros(n_bins, dtype=torch.float32, device=s.device).index_add_(0, bins, (1.0 - y_true) * w)
    return pos, neg


def auc_from_histogram(pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """Tie-aware AUC from (pos, neg) histograms: exact for scores quantized to the bins."""
    neg_below = torch.cumsum(neg, 0) - neg  # negatives strictly below each bin
    return (pos * (neg_below + 0.5 * neg)).sum() / (pos.sum() * neg.sum())


def log_loss(y_true, y_pred) -> float:
    y_true = np.asarray(y_true, dtype=np.float64).ravel()
    y_pred = np.clip(np.asarray(y_pred, dtype=np.float64).ravel(), 1e-15, 1 - 1e-15)
    return float(-np.mean(y_true * np.log(y_pred) + (1 - y_true) * np.log(1 - y_pred)))
