"""The faiss backend: a wrapper over a ``faiss`` index, imported at first use (an optional package).

Counterpart of ``torch_rechub_tpu/serving/faiss.py``: ``index_key`` is faiss's
``index_factory`` string (``"Flat"``, ``"HNSW{m}"``, ``"IVF{nlists},Flat"``)
under the inner-product or L2 metric; an untrained index is trained on the
items first.  ``ef_search`` sets an HNSW index's ``efSearch``, ``nprobe`` an
IVF index's ``nprobe``.  Embeddings may be numpy arrays or tensors
(``as_host``).
"""

from __future__ import annotations

import numpy as np

from .base import BaseBuilder, BaseIndexer, as_host, simple_context


class FaissIndexer(BaseIndexer):
    def __init__(self, index, ef_search=None, nprobe=None):
        import faiss  # an optional package, imported where it is used

        self._faiss = faiss
        self._index = index
        if ef_search is not None and hasattr(index, "hnsw"):
            index.hnsw.efSearch = ef_search
        if nprobe is not None and hasattr(index, "nprobe"):
            index.nprobe = nprobe

    def query(self, embeddings, top_k: int):
        q = np.ascontiguousarray(as_host(embeddings))
        if q.ndim == 1:
            q = q[None]
        dists, ids = self._index.search(q, top_k)
        return ids.astype(np.int64), dists

    def save(self, file_path) -> None:
        self._faiss.write_index(self._index, str(file_path))


class FaissBuilder(BaseBuilder):
    def __init__(self, index_key: str = "Flat", metric: str = "ip", ef_search=None, nprobe=None):
        self.index_key = index_key
        if metric not in ("ip", "l2"):
            raise ValueError(f"unsupported faiss metric {metric!r}")
        self.metric = metric
        self.ef_search = ef_search
        self.nprobe = nprobe

    def from_embeddings(self, embeddings):
        import faiss  # an optional package, imported where it is used

        emb = np.ascontiguousarray(as_host(embeddings))
        index = faiss.index_factory(emb.shape[1], self.index_key, faiss.METRIC_INNER_PRODUCT if self.metric == "ip" else faiss.METRIC_L2)
        if not index.is_trained:
            index.train(emb)
        index.add(emb)
        return simple_context(FaissIndexer(index, self.ef_search, self.nprobe))

    def from_index_file(self, index_file):
        import faiss  # an optional package, imported where it is used

        return simple_context(FaissIndexer(faiss.read_index(str(index_file)), self.ef_search, self.nprobe))
