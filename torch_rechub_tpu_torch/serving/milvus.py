"""The Milvus backend: a wrapper over a ``pymilvus`` collection on a Milvus server, imported at first use (an
optional package).

Counterpart of ``torch_rechub_tpu/serving/milvus.py``: ``from_embeddings``
connects, drops a collection of the same name, creates one of ``(id,
embedding)`` rows, inserts the items, builds a FLAT, HNSW or IVF_FLAT index
under the COSINE, IP or L2 metric and loads it; ``from_index_file`` loads a
collection by name.  The connection closes when the context exits; ``save``
flushes on the server.  A query pads missing hits with id -1 at distance 0.
Embeddings may be numpy arrays or tensors (``as_host``).
"""

from __future__ import annotations

import contextlib

import numpy as np

from .base import BaseBuilder, BaseIndexer, as_host


class MilvusIndexer(BaseIndexer):
    def __init__(self, collection, metric: str, search_params):
        self._collection = collection
        self.metric = metric
        self.search_params = search_params

    def query(self, embeddings, top_k: int):
        q = as_host(embeddings)
        if q.ndim == 1:
            q = q[None]
        res = self._collection.search(q.tolist(), "embedding", {"metric_type": self.metric.upper(), "params": self.search_params}, limit=top_k, output_fields=["id"])
        ids = np.full((len(q), top_k), -1, dtype=np.int64)
        dists = np.zeros((len(q), top_k), dtype=np.float32)
        for i, hits in enumerate(res):
            for j, hit in enumerate(hits):
                ids[i, j] = hit.id
                dists[i, j] = hit.distance
        return ids, dists

    def save(self, file_path) -> None:
        self._collection.flush()  # Milvus keeps the collection on the server


class MilvusBuilder(BaseBuilder):
    def __init__(self, collection_name: str = "rechub_items", index_type: str = "FLAT", metric: str = "ip", host: str = "localhost", port: str = "19530", index_params=None, search_params=None):
        if index_type not in ("FLAT", "HNSW", "IVF_FLAT"):
            raise ValueError(f"unsupported milvus index {index_type!r}")
        if metric not in ("ip", "l2", "cosine"):
            raise ValueError(f"unsupported milvus metric {metric!r}")
        self.collection_name = collection_name
        self.index_type = index_type
        self.metric = metric
        self.host = host
        self.port = port
        self.index_params = index_params or {}
        self.search_params = search_params or {}

    @contextlib.contextmanager
    def from_embeddings(self, embeddings):
        from pymilvus import Collection, CollectionSchema, DataType, FieldSchema, connections, utility  # optional, imported where used

        emb = as_host(embeddings)
        connections.connect(host=self.host, port=self.port)
        try:
            if utility.has_collection(self.collection_name):
                utility.drop_collection(self.collection_name)
            fields = [FieldSchema("id", DataType.INT64, is_primary=True), FieldSchema("embedding", DataType.FLOAT_VECTOR, dim=emb.shape[1])]
            collection = Collection(self.collection_name, CollectionSchema(fields))
            collection.insert([list(range(len(emb))), emb.tolist()])
            collection.create_index("embedding", {"index_type": self.index_type, "metric_type": self.metric.upper(), "params": self.index_params})
            collection.load()
            yield MilvusIndexer(collection, self.metric, self.search_params)
        finally:
            connections.disconnect("default")

    @contextlib.contextmanager
    def from_index_file(self, index_file):
        from pymilvus import Collection, connections  # optional, imported where used

        connections.connect(host=self.host, port=self.port)
        try:
            collection = Collection(str(index_file))  # the "file" is the collection's name
            collection.load()
            yield MilvusIndexer(collection, self.metric, self.search_params)
        finally:
            connections.disconnect("default")
