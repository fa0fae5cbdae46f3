"""Exact top-k by inner product, blocked over the items so that the score matrix fits."""

from __future__ import annotations

import torch


def scores_of(users: torch.Tensor, items: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``users[u] . items[ids[u, j]]`` for ``(U, d)`` users and ``(U, k)`` ids; -inf for an id that is
    no item or that a user's list repeats, so that such an answer reads as far below the best."""
    valid = (ids >= 0) & (ids < items.shape[0])
    s = torch.einsum("ud,ukd->uk", users, items[torch.where(valid, ids, 0)])
    ordered, _ = torch.sort(ids, dim=1)
    repeated = (ordered[:, 1:] == ordered[:, :-1]).any(dim=1, keepdim=True)
    return torch.where(valid & ~repeated, s, torch.full_like(s, -torch.inf))


def topk(users: torch.Tensor, items: torch.Tensor, k: int, block: int = 131072):
    """``(scores, ids)`` of the ``k`` best items of each user, best first; among equal scores the lower id first."""
    best_s = best_i = None
    for start in range(0, items.shape[0], block):
        s = users @ items[start:start + block].T
        i = torch.arange(start, start + s.shape[1], device=users.device).expand_as(s)
        if best_s is not None:
            s, i = torch.cat([best_s, s], dim=1), torch.cat([best_i, i], dim=1)
        # ascending id first, then a stable sort by score: ties keep the lower id in front
        order = torch.argsort(i, dim=1, stable=True)
        s, i = torch.gather(s, 1, order), torch.gather(i, 1, order)
        s, order = torch.sort(s, dim=1, descending=True, stable=True)
        best_s, best_i = s[:, :k], torch.gather(i, 1, order)[:, :k]
    return best_s, best_i
