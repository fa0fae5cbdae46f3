"""Retrieval metrics of the PyTorch port's examples (a copy of ``benchmarks/metrics.py``'s ``evaluate_retrieval``).

``evaluate_retrieval`` scores exact top-k retrieval through the port's
``serving.match_evaluation`` (``brute_force_topk`` on ``device``: the card
unless the caller names another), and with ``beyond_accuracy=True`` adds GAUC,
Diversity, Coverage and Novelty from the same exact lists.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from torch_rechub_tpu_torch.serving import match_evaluation


def evaluate_retrieval(user_emb, item_emb, test_user, all_item, user_col, item_col, topk: int, beyond_accuracy: bool = False, device=None) -> Dict[str, float]:
    """Exact top-k retrieval metrics (replacing the reference's Annoy path).

    With ``beyond_accuracy=True`` the same exact top-k lists additionally
    yield GAUC (per-user rank of the held-out item vs the whole catalog),
    intra-list Diversity, catalog Coverage and self-information Novelty —
    the reference ships these metric functions
    (``torch_rechub/basic/metric.py:203-313``) but never wires them into an
    eval.
    """
    res = match_evaluation(user_emb, item_emb, test_user, all_item, user_col=user_col, item_col=item_col, topk=topk, device=device)
    out = {}
    for name, values in res.items():
        out[f"{name}@{topk}"] = float(values[0].split(": ")[1])
    if beyond_accuracy:
        out.update(beyond_accuracy_scores(user_emb, item_emb, test_user, all_item, user_col, item_col, topk, device=device))
    return out


def beyond_accuracy_scores(user_emb, item_emb, test_user, all_item, user_col, item_col, topk: int, device=None) -> Dict[str, float]:
    """GAUC + Diversity/Coverage/Novelty from exact catalog-wide scores."""
    from torch_rechub_tpu_torch.basic.metric import coverage_score, diversity_score, novelty_score
    from torch_rechub_tpu_torch.serving import brute_force_topk

    user_emb = np.asarray(user_emb)
    item_emb = np.asarray(item_emb)
    if user_emb.ndim == 3:  # multi-interest: best-interest score per item
        scores = np.einsum("ukd,id->uki", user_emb, item_emb).max(axis=1)
        idx = np.argsort(-scores, axis=1)[:, :topk]
    else:
        scores = user_emb @ item_emb.T
        idx, _ = brute_force_topk(user_emb, item_emb, topk, device=device)
        idx = np.asarray(idx)
    item_ids = np.asarray(all_item[item_col])
    targets = np.asarray(test_user[item_col]) if item_col in test_user else None

    out = {}
    # GAUC: one positive (the held-out item) vs the whole catalog per user =
    # 1 - normalized rank of the target; mean over users with a known target.
    if targets is not None:
        id_to_row = {int(i): r for r, i in enumerate(item_ids)}
        aucs = []
        for u, t in enumerate(targets):
            r = id_to_row.get(int(t))
            if r is None:
                continue
            s = scores[u]
            aucs.append((np.sum(s < s[r]) + 0.5 * (np.sum(s == s[r]) - 1)) / max(len(s) - 1, 1))
        if aucs:
            out[f"GAUC@{len(item_ids)}"] = float(np.mean(aucs))

    rec_lists = {u: [int(item_ids[j]) for j in idx[u]] for u in range(idx.shape[0])}
    emb_by_id = {int(i): item_emb[r] for r, i in enumerate(item_ids)}
    div = diversity_score(rec_lists, emb_by_id, topKs=[topk])
    out[f"Diversity@{topk}"] = float(div["Diversity"][0].split(": ")[1])
    cov = coverage_score(rec_lists, [int(i) for i in item_ids], topKs=[topk])
    out[f"Coverage@{topk}"] = float(cov["Coverage"][0].split(": ")[1])
    counts = np.ones(len(item_ids))  # uniform popularity prior on the sample
    pop = {int(i): c / counts.sum() for i, c in zip(item_ids, counts)}
    nov = novelty_score(rec_lists, pop, topKs=[topk])
    out[f"Novelty@{topk}"] = float(nov["Novelty"][0].split(": ")[1])
    return out
