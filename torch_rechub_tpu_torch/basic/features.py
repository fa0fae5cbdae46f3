"""Declarative feature schema.

Counterpart of ``torch_rechub_tpu/basic/features.py``: frozen dataclasses
(vocab size, embed dim with the ``floor(6 * V**0.25)`` auto rule,
``shared_with`` table sharing, ``padding_idx``, pooling of sequence
features, an initializer spec).  They own no parameter:
:class:`~torch_rechub_tpu_torch.ops.embedding.EmbeddingCollection` does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

from .initializers import Initializer, RandomNormal


def auto_embedding_dim(vocab_size: int) -> int:
    """Default embedding dim ``floor(6 * vocab_size**0.25)``."""
    return int(math.floor(6 * vocab_size**0.25))


@dataclasses.dataclass(frozen=True)
class DenseFeature:
    """A numeric feature passed through as is; ``embed_dim`` is its width."""

    name: str
    embed_dim: int = 1

    def __repr__(self) -> str:
        return f"<DenseFeature {self.name}>"


@dataclasses.dataclass(frozen=True)
class SparseFeature:
    """A categorical id feature backed by an embedding table.

    ``embed_dim=None`` selects :func:`auto_embedding_dim`; ``shared_with``
    names the feature whose table this one reuses; the ``padding_idx`` row
    starts at zero and reads as zero.
    """

    name: str
    vocab_size: int
    embed_dim: Optional[int] = None
    shared_with: Optional[str] = None
    padding_idx: Optional[int] = None
    initializer: Initializer = dataclasses.field(default_factory=lambda: RandomNormal(0.0, 1e-4))

    def __post_init__(self):
        if self.embed_dim is None:
            object.__setattr__(self, "embed_dim", auto_embedding_dim(self.vocab_size))

    def __repr__(self) -> str:
        return f"<SparseFeature {self.name} with Embedding shape ({self.vocab_size}, {self.embed_dim})>"


@dataclasses.dataclass(frozen=True)
class SequenceFeature:
    """A padded id sequence backed by an embedding table.

    ``pooling`` is ``"mean" | "sum" | "concat"``; mean and sum skip the
    positions equal to ``padding_idx`` (or ``-1`` when it is unset), concat
    keeps ``(B, L, D)``.
    """

    name: str
    vocab_size: int
    embed_dim: Optional[int] = None
    pooling: str = "mean"
    shared_with: Optional[str] = None
    padding_idx: Optional[int] = None
    initializer: Initializer = dataclasses.field(default_factory=lambda: RandomNormal(0.0, 1e-4))

    def __post_init__(self):
        if self.embed_dim is None:
            object.__setattr__(self, "embed_dim", auto_embedding_dim(self.vocab_size))
        if self.pooling not in ("mean", "sum", "concat"):
            raise ValueError(f"pooling must be one of mean/sum/concat, got {self.pooling!r}")

    def __repr__(self) -> str:
        return f"<SequenceFeature {self.name} with Embedding shape ({self.vocab_size}, {self.embed_dim})>"


Feature = Union[DenseFeature, SparseFeature, SequenceFeature]


def table_name(feature: Feature) -> str:
    """The feature that owns the embedding table (``shared_with`` aware)."""
    shared = getattr(feature, "shared_with", None)
    return shared if shared is not None else feature.name


def embedded_features(features) -> Tuple[Feature, ...]:
    """Features that own or reference an embedding table (sparse + sequence)."""
    return tuple(f for f in features if isinstance(f, (SparseFeature, SequenceFeature)))


def dense_features(features) -> Tuple[DenseFeature, ...]:
    return tuple(f for f in features if isinstance(f, DenseFeature))
