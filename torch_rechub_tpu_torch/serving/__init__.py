"""Retrieval serving: exact top-k on the card behind the builder / indexer interface.

Counterpart of ``torch_rechub_tpu/serving/__init__.py``.  ``builder_factory``
serves ``"bruteforce"``; the approximate backends (``"annoy"``, ``"faiss"``,
``"milvus"``, ``"hnsw"`` with its C++ index) are not ported yet and raise.
"""

from .base import BaseBuilder, BaseIndexer
from .retrieval import brute_force_topk, match_evaluation, multi_interest_topk

ANN_BACKENDS = ("annoy", "faiss", "milvus", "hnsw")


def builder_factory(model: str, **builder_config) -> BaseBuilder:
    """A vector-index builder: ``"bruteforce"`` (exact, on the card)."""
    if model == "bruteforce":
        from .bruteforce import BruteForceBuilder

        return BruteForceBuilder(**builder_config)
    if model in ANN_BACKENDS:
        raise NotImplementedError(f"the {model!r} backend is not ported yet: the approximate backends come with ROADMAP queue 1, item 15; use 'bruteforce'")
    raise NotImplementedError(f"model={model!r} is not implemented yet!")


__all__ = ["builder_factory", "BaseBuilder", "BaseIndexer", "brute_force_topk", "multi_interest_topk", "match_evaluation"]
