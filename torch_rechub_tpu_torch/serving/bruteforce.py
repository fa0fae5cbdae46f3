"""The exact brute-force backend under the ``BaseBuilder`` / ``BaseIndexer`` interface.

Counterpart of ``torch_rechub_tpu/serving/bruteforce.py``: one product and
a top-k on the card per batch of queries (``retrieval.brute_force_topk``),
exact; the reference the approximate backends are measured against.
Metrics: ``ip`` (inner product), ``angular`` (both sides L2-normalised, the
scores cosines) and ``l2``: ``argmin |q − i|² = argmax (q·i − |i|²/2)``, so the
items take a bias column ``−|i|²/2`` and the queries a column of ones, and
the distances come back as ``|q|² − 2·score``.  The corpus (numpy, or a
tensor on any device) is prepared and moved to the device once per indexer,
the raw one kept where it came from; ``save`` writes it as ``.npy``.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import BaseBuilder, BaseIndexer, as_host, simple_context
from ..parallel.mesh import check_mesh
from ..trainers.base import resolve_device
from .retrieval import as_matrix, brute_force_topk


def _normalized(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=1, keepdim=True), 1e-12)


class BruteForceIndexer(BaseIndexer):
    def __init__(self, embeddings: np.ndarray, metric: str = "ip", mesh=None, device=None):
        check_mesh(mesh)
        self.metric, self.mesh = metric, mesh
        self.device = resolve_device(device)
        self.embeddings = embeddings  # the raw corpus where it came from, for save
        items = as_matrix(embeddings, self.device)
        if metric == "angular":
            items = _normalized(items)
        elif metric == "l2":
            items = torch.cat([items, -0.5 * (items * items).sum(1, keepdim=True)], dim=1)
        self._items = items

    def query(self, embeddings, top_k: int):
        q = as_matrix(embeddings, self.device)
        q = q[None] if q.ndim == 1 else q
        if self.metric == "angular":
            q = _normalized(q)
        if self.metric == "l2":
            idx, scores = brute_force_topk(torch.cat([q, torch.ones_like(q[:, :1])], dim=1), self._items, top_k, mesh=self.mesh, device=self.device)
            return idx, (q * q).sum(1, keepdim=True).cpu().numpy() - 2 * scores
        return brute_force_topk(q, self._items, top_k, mesh=self.mesh, device=self.device)

    def save(self, file_path) -> None:
        np.save(str(file_path), as_host(self.embeddings))


class BruteForceBuilder(BaseBuilder):
    def __init__(self, metric: str = "ip", mesh=None, device=None):
        if metric not in ("ip", "l2", "angular", "dot"):
            raise ValueError(f"unsupported metric {metric!r}")
        check_mesh(mesh)
        self.metric = "ip" if metric == "dot" else metric
        self.mesh, self.device = mesh, device

    def from_embeddings(self, embeddings):
        return simple_context(BruteForceIndexer(embeddings, self.metric, self.mesh, self.device))

    def from_index_file(self, index_file):
        path = str(index_file)
        if not path.endswith(".npy"):
            path = path + ".npy"
        return simple_context(BruteForceIndexer(np.load(path), self.metric, self.mesh, self.device))
