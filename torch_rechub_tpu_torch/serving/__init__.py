"""Retrieval serving: exact top-k on the card and the approximate backends behind one interface.

Counterpart of ``torch_rechub_tpu/serving/__init__.py``.  ``builder_factory``
serves ``"bruteforce"`` (exact, on the card), ``"hnsw"`` (the in-repo C++
graph index, on the host) and the wrappers of the optional packages
``"annoy"``, ``"faiss"`` and ``"milvus"``, each imported at its first use.
"""

from .base import BaseBuilder, BaseIndexer
from .retrieval import brute_force_topk, match_evaluation, multi_interest_topk


def builder_factory(model: str, **builder_config) -> BaseBuilder:
    """A vector-index builder: annoy | faiss | milvus | bruteforce | hnsw."""
    if model == "annoy":
        from .annoy import AnnoyBuilder

        return AnnoyBuilder(**builder_config)
    if model == "faiss":
        from .faiss import FaissBuilder

        return FaissBuilder(**builder_config)
    if model == "milvus":
        from .milvus import MilvusBuilder

        return MilvusBuilder(**builder_config)
    if model == "bruteforce":
        from .bruteforce import BruteForceBuilder

        return BruteForceBuilder(**builder_config)
    if model == "hnsw":
        from .hnsw import HnswBuilder

        return HnswBuilder(**builder_config)
    raise NotImplementedError(f"model={model!r} is not implemented yet!")


__all__ = ["builder_factory", "BaseBuilder", "BaseIndexer", "brute_force_topk", "multi_interest_topk", "match_evaluation"]
