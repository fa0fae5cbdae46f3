"""Exact brute-force top-k retrieval on the card.

Counterpart of ``torch_rechub_tpu/serving/retrieval.py``: for each batch of
users one ``(U, N)`` score matrix ``u @ items.T`` (cuBLAS) and
``torch.topk`` over it; ``batch_size`` users at a time bound the score
matrix (``batch_size · N · 4`` bytes).  Among equal scores ``torch.topk``
may return another id than ``jax.lax.top_k`` (which takes the lower index
first); the scores agree.  ``multi_interest_topk`` merges a user's interests
on the host (the best score per item, deduplicated in a stable order), and
``match_evaluation`` runs the retrieval protocol of the examples: embed,
exact top-k, ``topk_metrics``, without pandas.

Inputs may be numpy arrays or tensors; the work runs on ``device``, the
card unless the caller names another (with no card and no device it
raises), and the results come back as numpy.

With ``mesh=`` (every rank of it calls with the same inputs) the corpus is
split over all the mesh's ranks when its rows divide evenly, else
replicated, as in the JAX package: each rank takes the top k of its rows,
and the ranks' k candidates, gathered, merge in ``jax.lax.top_k``'s order,
the lower index first among equal scores (among the candidates: a tie at a
rank's k-th score is cut by ``torch.topk``).  Every rank gets the result.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..parallel.distributed import all_gather
from ..parallel.mesh import check_mesh
from ..trainers.base import resolve_device


def as_matrix(x, device) -> torch.Tensor:
    """``x`` as a float32 tensor on ``device`` (no copy when it is one already)."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def topk_scores(users: torch.Tensor, items: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ids, scores)`` of the ``k`` best items of each user of one batch, on the tensors' device."""
    scores, ids = torch.topk(users @ items.T, k, dim=1)
    return ids, scores


def merge_topk(ids: torch.Tensor, scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` best of ``(U, n)`` candidate ``(ids, scores)``, equal scores in ascending id order."""
    order = torch.argsort(ids, dim=1, stable=True)
    ids, scores = torch.gather(ids, 1, order), torch.gather(scores, 1, order)
    scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
    return torch.gather(ids, 1, order)[:, :k], scores[:, :k]


def brute_force_topk(user_emb, item_emb, k: int, batch_size: int = 8192, mesh=None, device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Exact top-k items per user by inner product: ``(ids int64, scores float32)``, each ``(U, k)``."""
    check_mesh(mesh)
    device = resolve_device(device)
    users, items = as_matrix(user_emb, device), as_matrix(item_emb, device)
    split = mesh is not None and items.shape[0] % mesh.size == 0
    offset = 0
    if split:
        n = items.shape[0] // mesh.size
        offset = torch.distributed.get_rank() * n
        items = items[offset: offset + n]
    ids, scores = [], []
    for start in range(0, users.shape[0], batch_size):
        i, s = topk_scores(users[start:start + batch_size], items, k)
        if split:  # every rank's candidates, merged
            i, s = merge_topk(all_gather(i + offset, None, dim=1), all_gather(s, None, dim=1), k)
        ids.append(i)
        scores.append(s)
    return torch.cat(ids).cpu().numpy(), torch.cat(scores).cpu().numpy()


def multi_interest_topk(user_emb, item_emb, k: int, mesh=None, device=None) -> np.ndarray:
    """Top-k ids for ``(U, K, D)`` multi-interest users: each interest's top k, merged by the best score per
    item (a stable sort, then the first occurrence of each id), padded with the last id if short."""
    u, n_int, d = user_emb.shape
    idx, vals = brute_force_topk(user_emb.reshape(u * n_int, d), item_emb, k, mesh=mesh, device=device)
    idx, vals = idx.reshape(u, n_int * k), vals.reshape(u, n_int * k)
    out_idx = np.zeros((u, k), dtype=idx.dtype)
    for i in range(u):
        seen, picked = set(), []
        for j in np.argsort(-vals[i], kind="stable"):
            if idx[i, j] not in seen:
                seen.add(idx[i, j])
                picked.append(idx[i, j])
                if len(picked) == k:
                    break
        while len(picked) < k:
            picked.append(picked[-1] if picked else 0)
        out_idx[i] = picked
    return out_idx


def match_evaluation(user_embedding, item_embedding, test_user, all_item, user_col="user_id", item_col="item_id", raw_id_maps: Optional[str] = None, topk: int = 10, mesh=None, device=None):
    """Retrieval evaluation: exact top-k of each test row's user embedding, then ``topk_metrics`` against
    the test items grouped by user.

    ``user_embedding`` rows align one to one with ``test_user`` rows; a
    ``(U, K, D)`` embedding goes through :func:`multi_interest_topk`.
    ``raw_id_maps`` (a ``.npy`` of ``(user_map, item_map)``) restores raw ids
    before the metrics.  A user with several test rows keeps the list of
    its last row, as in the JAX package.
    """
    from ..basic.metric import topk_metrics

    user_embedding = np.asarray(user_embedding)
    item_embedding = np.asarray(item_embedding)
    users = np.asarray(test_user[user_col])
    if user_embedding.shape[0] != len(users):
        raise ValueError(f"user_embedding rows ({user_embedding.shape[0]}) must align 1:1 with test_user rows ({len(users)})")
    user_map = item_map = None
    if raw_id_maps is not None:
        user_map, item_map = np.load(raw_id_maps, allow_pickle=True)

    if user_embedding.ndim == 3:
        idx = multi_interest_topk(user_embedding, item_embedding, topk, mesh=mesh, device=device)
    else:
        idx, _ = brute_force_topk(user_embedding, item_embedding, topk, mesh=mesh, device=device)

    item_ids = np.asarray(all_item[item_col])
    match_res = {}
    for row, user_id in enumerate(users):
        rec = item_ids[idx[row]]
        if item_map is not None:
            rec = [item_map.get(r) for r in rec]
        match_res[user_map[user_id] if user_map is not None else user_id] = list(rec)

    ground_truth = {}
    for user_id, item_id in zip(users, np.asarray(test_user[item_col])):
        key = user_map.get(user_id) if user_map is not None else user_id
        ground_truth.setdefault(key, []).append(item_map.get(item_id) if item_map is not None else item_id)
    ground_truth = dict(sorted(ground_truth.items()))  # pandas' groupby order

    out = topk_metrics(y_true=ground_truth, y_pred=match_res, topKs=[topk])
    print(out)
    return out
