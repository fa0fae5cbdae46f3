"""The vector-index abstraction of the retrieval stage.

Counterpart of ``torch_rechub_tpu/serving/base.py``: a ``BaseBuilder`` owns
the build-time configuration and yields a ``BaseIndexer`` through the
context-managed ``from_embeddings`` / ``from_index_file``; an indexer answers
``query(embeddings, top_k) -> (ids, distances)`` and ``save(path)``.  The
results are numpy; embeddings may be numpy arrays or tensors, which a host
index (HNSW, annoy, faiss, milvus) reads through :func:`as_host` and the
brute-force index moves to its device.
"""

from __future__ import annotations

import abc
import contextlib
from typing import ContextManager, Tuple

import numpy as np
import torch


def as_host(x) -> np.ndarray:
    """``x`` (a numpy array, a list, or a tensor on any device, copied to the host) as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, dtype=np.float32)


class BaseIndexer(abc.ABC):
    @abc.abstractmethod
    def query(self, embeddings: np.ndarray, top_k: int) -> Tuple[np.ndarray, np.ndarray]:
        """``(ids, distances)``, each of shape ``(n, top_k)``."""

    @abc.abstractmethod
    def save(self, file_path) -> None:
        """Write the index to disk."""


class BaseBuilder(abc.ABC):
    @abc.abstractmethod
    def from_embeddings(self, embeddings: np.ndarray) -> ContextManager[BaseIndexer]:
        """Build an index over an ``(n, d)`` embedding matrix."""

    @abc.abstractmethod
    def from_index_file(self, index_file) -> ContextManager[BaseIndexer]:
        """Load an index saved before."""


@contextlib.contextmanager
def simple_context(indexer: BaseIndexer):
    """The lifecycle of an in-process indexer: yield it, then ``close()`` it if it has one."""
    try:
        yield indexer
    finally:
        close = getattr(indexer, "close", None)
        if close is not None:
            close()
