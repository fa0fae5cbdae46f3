"""The annoy backend: a wrapper over ``annoy.AnnoyIndex``, imported at first use (an optional package).

Counterpart of ``torch_rechub_tpu/serving/annoy.py``: items are added one row
at a time, ``build(n_trees)``, and each query row asks
``get_nns_by_vector(row, top_k, search_k, include_distances=True)``; a query
that finds fewer than ``top_k`` items is padded with id -1 at distance 0.
Embeddings may be numpy arrays or tensors (``as_host``).
"""

from __future__ import annotations

import numpy as np

from .base import BaseBuilder, BaseIndexer, as_host, simple_context


class AnnoyIndexer(BaseIndexer):
    def __init__(self, index, search_k: int = -1):
        self._index = index
        self.search_k = search_k

    def query(self, embeddings, top_k: int):
        q = as_host(embeddings)
        if q.ndim == 1:
            q = q[None]
        ids = np.empty((len(q), top_k), dtype=np.int64)
        dists = np.empty((len(q), top_k), dtype=np.float32)
        for i, row in enumerate(q):  # annoy takes one vector a query
            idx, d = self._index.get_nns_by_vector(row.tolist(), top_k, search_k=self.search_k, include_distances=True)
            ids[i] = list(idx) + [-1] * (top_k - len(idx))
            dists[i] = list(d) + [0.0] * (top_k - len(d))
        return ids, dists

    def save(self, file_path) -> None:
        self._index.save(str(file_path))


class AnnoyBuilder(BaseBuilder):
    """``metric`` angular | euclidean | dot | manhattan | hamming, ``n_trees``, ``search_k``; ``dim`` to load a file."""

    def __init__(self, metric: str = "angular", n_trees: int = 10, search_k: int = -1, dim: int = None):
        if metric not in ("angular", "euclidean", "dot", "manhattan", "hamming"):
            raise ValueError(f"unsupported annoy metric {metric!r}")
        self.metric = metric
        self.n_trees = n_trees
        self.search_k = search_k
        self.dim = dim

    def _make(self, dim):
        from annoy import AnnoyIndex  # an optional package, imported where it is used

        return AnnoyIndex(dim, self.metric)

    def from_embeddings(self, embeddings):
        emb = as_host(embeddings)
        index = self._make(emb.shape[1])
        for i, row in enumerate(emb):
            index.add_item(i, row.tolist())
        index.build(self.n_trees)
        return simple_context(AnnoyIndexer(index, self.search_k))

    def from_index_file(self, index_file):
        if self.dim is None:
            raise ValueError("dim is required to load an annoy index")
        index = self._make(self.dim)
        index.load(str(index_file))
        return simple_context(AnnoyIndexer(index, self.search_k))
