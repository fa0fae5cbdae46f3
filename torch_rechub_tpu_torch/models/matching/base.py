"""What the matching models share.

Counterpart of ``torch_rechub_tpu/models/matching/base.py``.  Every
matching model follows the two-tower "mode protocol": ``forward(x)``
returns the training scores, ``forward(x, mode="user" | "item")`` that
tower's embedding, and ``towers(x)`` both towers' embeddings for the
in-batch negative path of ``MatchTrainer``.  Train or eval mode is the
module's own (``model.train()`` / ``model.eval()``), where flax takes a
``training`` argument; dropout masks and MIND's routing start come from
the ``generator`` the trainer passes.
"""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """``x / max(|x|₂, eps)`` along ``dim``: ``F.normalize(p=2)``'s semantics."""
    return x / torch.clamp_min(torch.sqrt((x * x).sum(dim, keepdim=True)), eps)
