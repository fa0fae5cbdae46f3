"""Evaluation metrics.

Counterpart of ``torch_rechub_tpu/basic/metric.py``: the exact tie-aware
AUC on the host (numpy), and the bucketed AUC whose per-batch score
histograms add up on the device, so only one scalar reaches the host
(``auc_score_bucketed`` in one call); the per-user AUC ``gauc_score``; the
retrieval metrics of per-user recommendation lists (``topk_metrics``:
NDCG, MRR, recall, hit and precision at K; diversity, coverage, novelty),
on the host.
"""

from __future__ import annotations

from collections import defaultdict
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


def auc_score_bucketed(y_true, y_score, n_bins: int = 65536) -> float:
    """Histogram AUC in one call (labels and scores from the host, or tensors on their device)."""
    y_true, y_score = (torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a) for a in (y_true, y_score))
    pos, neg = auc_histogram(y_true, y_score, n_bins=n_bins)
    return float(auc_from_histogram(pos, neg))


def get_user_pred(y_true, y_pred, users):
    """Labels and scores grouped by user id: ``{user: {"y_true": [...], "y_pred": [...]}}``."""
    user_pred = {}
    for t, p, u in zip(y_true, y_pred, users):
        entry = user_pred.setdefault(u, {"y_true": [], "y_pred": []})
        entry["y_true"].append(t)
        entry["y_pred"].append(p)
    return user_pred


def gauc_score(y_true, y_pred, users, weights=None) -> float:
    """Per-user AUC averaged with impression-count (or the given per-user) weights."""
    if not len(y_true) == len(y_pred) == len(users):
        raise ValueError(f"gauc_score: {len(y_true)} labels, {len(y_pred)} scores, {len(users)} users")
    total, norm = 0.0, 0.0
    for u, d in get_user_pred(y_true, y_pred, users).items():
        w = len(d["y_true"]) if weights is None else weights[u]
        total += auc_score(d["y_true"], d["y_pred"]) * w
        norm += w
    return total / norm


def log_loss(y_true, y_pred) -> float:
    y_true = np.asarray(y_true, dtype=np.float64).ravel()
    y_pred = np.clip(np.asarray(y_pred, dtype=np.float64).ravel(), 1e-15, 1 - 1e-15)
    return float(-np.mean(y_true * np.log(y_pred) + (1 - y_true) * np.log(1 - y_pred)))


def topk_metrics(y_true, y_pred, topKs=None):
    """NDCG / MRR / Recall / Hit / Precision at each K over ``{user: [items]}`` dicts.

    Hit is normalised by the total ground-truth count, the others by the
    number of users; the values are strings ``"Metric@K: value"``, rounded
    to 4 places.
    """
    if topKs is None:
        topKs = [5]
    if not isinstance(topKs, (tuple, list)):
        raise ValueError("topKs wrong, it should be tuple or list")
    assert len(y_true) == len(y_pred)

    users = list(y_true.keys())
    n_users = len(users)
    results = defaultdict(list)
    for k in topKs:
        ndcgs = mrrs = hits = precisions = recalls = 0.0
        gts = 0
        for u in users:
            truth = y_true[u]
            if len(truth) == 0:
                continue
            truth_set = set(truth)
            rec = y_pred[u][:k]
            rel = np.array([1.0 if it in truth_set else 0.0 for it in rec])
            discounts = 1.0 / np.log2(np.arange(len(rec)) + 2.0)
            hit_cnt = float(rel.sum())
            dcg = float((rel * discounts).sum())
            idcg = float(discounts[: min(k, len(truth))].sum())
            first_hit = np.flatnonzero(rel)
            gts += len(truth)
            hits += hit_cnt
            mrrs += 1.0 / (1.0 + first_hit[0]) if first_hit.size else 0.0
            recalls += hit_cnt / len(truth)
            precisions += hit_cnt / k
            if idcg > 0:
                ndcgs += dcg / idcg
        results["NDCG"].append(f"NDCG@{k}: {round(ndcgs / n_users, 4)}")
        results["MRR"].append(f"MRR@{k}: {round(mrrs / n_users, 4)}")
        results["Recall"].append(f"Recall@{k}: {round(recalls / n_users, 4)}")
        results["Hit"].append(f"Hit@{k}: {round(hits / gts, 4)}")
        results["Precision"].append(f"Precision@{k}: {round(precisions / n_users, 4)}")
    return results


def ndcg_score(y_true, y_pred, topKs=None):
    return topk_metrics(y_true, y_pred, topKs or [5])["NDCG"]


def mrr_score(y_true, y_pred, topKs=None):
    return topk_metrics(y_true, y_pred, topKs or [5])["MRR"]


def recall_score(y_true, y_pred, topKs=None):
    return topk_metrics(y_true, y_pred, topKs or [5])["Recall"]


def hit_score(y_true, y_pred, topKs=None):
    return topk_metrics(y_true, y_pred, topKs or [5])["Hit"]


def precision_score(y_true, y_pred, topKs=None):
    return topk_metrics(y_true, y_pred, topKs or [5])["Precision"]


def diversity_score(y_pred, item_embeddings, topKs=None):
    """Intra-list diversity: the mean pairwise cosine distance inside each list, averaged over users."""
    if topKs is None:
        topKs = [5]
    results = defaultdict(list)
    emb_is_dict = isinstance(item_embeddings, dict)
    for k in topKs:
        per_user = []
        for u, rec in y_pred.items():
            embs = []
            for it in rec[:k]:
                if emb_is_dict:
                    if it in item_embeddings:
                        embs.append(np.asarray(item_embeddings[it], dtype=np.float64))
                elif it < len(item_embeddings):
                    embs.append(np.asarray(item_embeddings[it], dtype=np.float64))
            n = len(embs)
            if n < 2:
                continue
            mat = np.stack(embs)
            mat = mat / np.maximum(np.linalg.norm(mat, axis=1, keepdims=True), 1e-10)
            dist_sum = float((1.0 - mat @ mat.T)[np.triu_indices(n, k=1)].sum())
            per_user.append(dist_sum / (n * (n - 1) / 2))
        score = round(float(np.mean(per_user)), 4) if per_user else 0.0
        results["Diversity"].append(f"Diversity@{k}: {score}")
    return results


def coverage_score(y_pred, all_items, topKs=None):
    """Catalogue coverage: the share of the catalogue that appears in any top-k list."""
    if topKs is None:
        topKs = [5]
    results = defaultdict(list)
    for k in topKs:
        rec = set()
        for items in y_pred.values():
            rec.update(items[:k])
        results["Coverage"].append(f"Coverage@{k}: {round(len(rec) / len(all_items), 4)}")
    return results


def novelty_score(y_pred, item_popularity, topKs=None):
    """Mean self-information ``-log2(popularity)`` of the recommended items, averaged over users."""
    if topKs is None:
        topKs = [5]
    results = defaultdict(list)
    for k in topKs:
        per_user = []
        for items in y_pred.values():
            rec = items[:k]
            if len(rec) == 0:
                continue
            per_user.append(float(np.mean([-np.log2(max(item_popularity.get(it, 1e-10), 1e-10)) for it in rec])))
        score = round(float(np.mean(per_user)), 4) if per_user else 0.0
        results["Novelty"].append(f"Novelty@{k}: {score}")
    return results
