"""EmbeddingCollection: the embedding tables of a feature schema, their lookups and pooling.

Counterpart of ``torch_rechub_tpu/ops/embedding.py``: one table per feature
group (``shared_with`` resolved by the schema), lookups as gathers,
mask-aware sum / mean pooling of sequence features, dense passthrough and
the ``squeeze_dim`` flattening contract.

Table layout (``fused``): ``True`` stores all tables of one embed_dim as one
``(ΣV, D)`` parameter ``fused_d{D}_table``, padded to
``(ΣV // 64 + 1) * 64`` rows (always at least one spare row), and gathers a
batch's ids for all its features at once; ``False`` keeps one
``{owner}_table`` per feature group, padded to a multiple of 64 rows from
65,536 rows on; ``"auto"`` (the default) fuses only tables of at least
262,144 rows.  Padded rows are zero and no id addresses them.  The names,
shapes and row offsets are those of the JAX package, so its weights load
as they are (``utils/jax_weights.py``).

Ids are read as ``jnp.take`` reads them: a negative id counts from the end
of the table it is gathered from (``-1`` is the table's last row; in the
fused table, the previous table's last row, or the spare row for the first
table).  Ids of at least the table's rows are the caller's error.  The
``padding_idx`` row is masked by a multiply, so it reads as zero and takes
no gradient.

Inside a sparse step (``ops.sparse_update.record_rows``) the fused gather
is the hook of the sparse row-wise updates: the rows come from the
detached table as a leaf that takes their gradient, and the recorder keeps
it with the unwrapped ids (``ids + offset``).  The padding mask applies
after that leaf, so a padding id's rows take a zero gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..basic.features import DenseFeature, Feature, SequenceFeature, SparseFeature, table_name
from ..basic.precision import compute_dtype
from .sparse_update import gather_rows, outside_hooks

# The process-wide default of EmbeddingCollection.fused.
_FUSED_DEFAULT = ["auto"]
# Fused tables pad ΣV to the NEXT multiple of this, so at least one row is spare.
_FUSED_ROW_MULTIPLE = 64
# "auto": tables of at least this many rows join the fused parameter.
_FUSED_AUTO_MIN_ROWS = 262144
# Per-feature tables of at least this many rows pad to a multiple of 64.
_PER_FEATURE_PAD_MIN_ROWS = 65536


def set_fused_default(value):
    """Set the process-wide default layout (``True | False | "auto"``); returns the previous one."""
    if value not in (True, False, "auto"):
        raise ValueError(f"fused default must be True, False or 'auto', got {value!r}")
    old = _FUSED_DEFAULT[0]
    _FUSED_DEFAULT[0] = value
    return old


def feature_mask(x: Mapping[str, torch.Tensor], feature) -> torch.Tensor:
    """Float validity mask: positions != padding_idx (or != -1 when unset)."""
    pad = feature.padding_idx if feature.padding_idx is not None else -1
    return (x[feature.name] != pad).to(torch.float32)


def pool_sequence(emb: torch.Tensor, mask: torch.Tensor, pooling: str) -> torch.Tensor:
    """Masked pooling over the L axis of ``(B, L, D)`` embeddings; ``concat`` keeps ``(B, L, D)``."""
    if pooling == "concat":
        return emb
    masked_sum = torch.einsum("bl,bld->bd", mask.to(emb.dtype), emb)
    if pooling == "sum":
        return masked_sum
    if pooling == "mean":
        return masked_sum / (mask.sum(-1, keepdim=True) + 1e-16)
    raise ValueError(f"unsupported pooling {pooling!r}")


@dataclasses.dataclass(frozen=True)
class TableLayout:
    """Where each owner's rows live.

    ``specs``: owner -> the feature that owns the table; ``per_feature``:
    owner -> rows of its own table; ``fused``: dim -> (rows, owners in row
    order); ``offsets``: fused owner -> (dim, first row).
    """

    specs: Dict[str, Feature]
    per_feature: Dict[str, int]
    fused: Dict[int, Tuple[int, Tuple[str, ...]]]
    offsets: Dict[str, Tuple[int, int]]

    def shapes(self) -> Dict[str, Tuple[int, int]]:
        """``{parameter name: (rows, dim)}``, the JAX package's parameter names."""
        out = {f"{owner}_table": (rows, self.specs[owner].embed_dim) for owner, rows in self.per_feature.items()}
        out.update({f"fused_d{dim}_table": (rows, dim) for dim, (rows, _) in self.fused.items()})
        return out


def table_layout(features: Sequence[Feature], fused=None) -> TableLayout:
    """The tables a schema needs under a layout, without allocating any."""
    specs = {}
    for fea in features:
        if isinstance(fea, DenseFeature):
            continue
        owner = table_name(fea)
        if getattr(fea, "shared_with", None) is not None or owner in specs:
            continue
        specs[owner] = fea
    mode = fused if fused is not None else _FUSED_DEFAULT[0]
    if mode not in (True, False, "auto"):
        raise ValueError(f"fused must be True, False or 'auto', got {mode!r}")
    if mode == "auto":
        to_fuse = [o for o, f in specs.items() if f.vocab_size >= _FUSED_AUTO_MIN_ROWS]
    else:
        to_fuse = list(specs) if mode else []

    per_feature = {}
    for owner, fea in specs.items():
        if owner not in to_fuse:
            rows = fea.vocab_size
            if rows >= _PER_FEATURE_PAD_MIN_ROWS:
                rows = -(-rows // _FUSED_ROW_MULTIPLE) * _FUSED_ROW_MULTIPLE
            per_feature[owner] = rows

    groups: Dict[int, list] = {}
    for owner in to_fuse:
        groups.setdefault(specs[owner].embed_dim, []).append(owner)
    offsets, fused_tables = {}, {}
    for dim, owners in groups.items():
        total = 0
        for owner in owners:
            offsets[owner] = (dim, total)
            total += specs[owner].vocab_size
        fused_tables[dim] = ((total // _FUSED_ROW_MULTIPLE + 1) * _FUSED_ROW_MULTIPLE, tuple(owners))
    return TableLayout(specs, per_feature, fused_tables, offsets)


def squeeze_width(features: Sequence[Feature]) -> int:
    """Width of the ``squeeze_dim=True`` output for ``features``: the input width of a layer on it."""
    width = 0
    for fea in features:
        if isinstance(fea, SequenceFeature) and fea.pooling == "concat":
            raise ValueError(f"{fea.name}: a concat-pooled sequence's flat width depends on its length, which the schema does not hold")
        width += fea.embed_dim
    return width


def _init_rows(fea, generator) -> torch.Tensor:
    w = fea.initializer((fea.vocab_size, fea.embed_dim), generator)
    if fea.padding_idx is not None:
        w[fea.padding_idx] = 0.0
    return w


def _ids(x: Mapping[str, torch.Tensor], feature) -> torch.Tensor:
    ids = x[feature.name]
    return ids if ids.dtype in (torch.int32, torch.int64) else ids.to(torch.int64)


def _gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)`` for ids in [-rows, rows): negative ids count from the end."""
    return F.embedding(torch.where(ids < 0, ids + table.shape[0], ids), table)


class EmbeddingCollection(nn.Module):
    """Owns one table per feature group (or the fused tables); serves lookups and pooling.

    Tables are drawn on the CPU from ``generator`` by each owner's
    initializer, in the JAX package's order, and moved to ``device``.
    """

    def __init__(self, features: Sequence[Feature], fused=None, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.features = tuple(features)
        self.layout = table_layout(self.features, fused)
        specs = self.layout.specs
        for owner, rows in self.layout.per_feature.items():
            w = torch.zeros(rows, specs[owner].embed_dim)
            w[: specs[owner].vocab_size] = _init_rows(specs[owner], generator)
            self.register_parameter(f"{owner}_table", nn.Parameter(w.to(device)))
        for dim, (rows, owners) in self.layout.fused.items():
            w = torch.zeros(rows, dim)
            for owner in owners:
                off = self.layout.offsets[owner][1]
                w[off: off + specs[owner].vocab_size] = _init_rows(specs[owner], generator)
            self.register_parameter(f"fused_d{dim}_table", nn.Parameter(w.to(device)))

    def table(self, name: str) -> torch.Tensor:
        """The ``(V, D)`` table of one owner feature (a slice if fused or row-padded).

        Inside a sparse step that owns the table, the slice is of the
        detached table (``ops.sparse_update.outside_hooks``): a direct read
        takes no gradient there, as in the JAX package's sparse step.
        """
        v = self.layout.specs[name].vocab_size
        if name in self.layout.offsets:
            dim, off = self.layout.offsets[name]
            return outside_hooks(getattr(self, f"fused_d{dim}_table"))[off: off + v]
        return outside_hooks(getattr(self, f"{name}_table"))[:v]

    def lookup(self, x: Mapping[str, torch.Tensor], feature) -> torch.Tensor:
        """Gather the rows of one sparse or sequence feature; the padding_idx row reads as 0."""
        ids = _ids(x, feature)
        owner = table_name(feature)
        if owner in self.layout.offsets:
            dim, off = self.layout.offsets[owner]
            emb = _gather(getattr(self, f"fused_d{dim}_table"), ids + off)
        else:
            emb = _gather(getattr(self, f"{owner}_table"), ids)
        if feature.padding_idx is not None:
            emb = emb * (ids != feature.padding_idx)[..., None].to(emb.dtype)
        return emb.to(compute_dtype())

    def _fused_batched_embed(self, x: Mapping[str, torch.Tensor], features) -> Dict[int, torch.Tensor]:
        """One gather per fused table for all its features: ``{index in features: (B, [L,] D)}``.

        The single ``(B, T, D)`` gather per dim group is the sparse updates'
        hook: under an open recorder that owns the table, it records the
        gathered rows and their unwrapped ids (module docstring).
        """
        by_dim: Dict[int, list] = {}
        for idx, fea in enumerate(features):
            if isinstance(fea, (SparseFeature, SequenceFeature)) and table_name(fea) in self.layout.offsets:
                by_dim.setdefault(fea.embed_dim, []).append((idx, fea))
        out = {}
        for dim, items in by_dim.items():
            raw = [_ids(x, fea) for _, fea in items]
            raw = [ids[:, None] if ids.ndim == 1 else ids for ids in raw]  # scalar ids -> (B, 1)
            segs = [ids + self.layout.offsets[table_name(fea)][1] for ids, (_, fea) in zip(raw, items)]
            table, all_ids = getattr(self, f"fused_d{dim}_table"), segs[0] if len(segs) == 1 else torch.cat(segs, dim=1)
            emb = gather_rows(table, all_ids, _gather)
            pos = 0
            for (idx, fea), ids in zip(items, raw):
                e = emb[:, pos: pos + ids.shape[1]]
                pos += ids.shape[1]
                if fea.padding_idx is not None:
                    e = e * (ids != fea.padding_idx)[..., None].to(e.dtype)
                e = e.to(compute_dtype())
                # scalar ids give (B, D); 2-D ids keep (B, W, D), as lookup() does
                out[idx] = e[:, 0] if x[fea.name].ndim == 1 else e
        return out

    def forward(self, x: Mapping[str, torch.Tensor], features: Sequence[Feature], squeeze_dim: bool = False) -> torch.Tensor:
        """Embed and pool ``features`` of a dict-of-tensors batch.

        ``(B, F, D)`` stacked sparse embeddings; with ``squeeze_dim`` the flat
        ``(B, ΣD [+ n_dense])`` concat (sparse first, then dense), or
        ``(B, n_dense)`` when there are only dense features.
        """
        batched = self._fused_batched_embed(x, features) if self.layout.offsets else {}
        sparse_emb, dense_values = [], []
        for idx, fea in enumerate(features):
            if isinstance(fea, SparseFeature):
                e = batched[idx] if idx in batched else self.lookup(x, fea)
                sparse_emb.append(e[:, None, :])
            elif isinstance(fea, SequenceFeature):
                e = batched[idx] if idx in batched else self.lookup(x, fea)
                sparse_emb.append(pool_sequence(e, feature_mask(x, fea), fea.pooling)[:, None, ...])
            elif isinstance(fea, DenseFeature):
                v = x[fea.name].to(compute_dtype())
                dense_values.append(v if v.ndim > 1 else v[:, None])
            else:
                raise TypeError(f"unknown feature type: {fea!r}")

        dense_out = torch.cat(dense_values, dim=1) if dense_values else None
        sparse_out = torch.cat(sparse_emb, dim=1) if sparse_emb else None
        if squeeze_dim:
            if sparse_out is None:
                if dense_out is None:
                    raise ValueError("input features cannot be empty")
                return dense_out
            flat = sparse_out.reshape(sparse_out.shape[0], -1)
            return flat if dense_out is None else torch.cat([flat, dense_out], dim=1)
        if sparse_out is None:
            raise ValueError("non-squeeze output requires sparse/sequence features")
        return sparse_out
