"""Row-wise sparse updates of embedding tables, and the recorder of the gathered rows.

Counterpart of ``torch_rechub_tpu/ops/sparse_update.py``.  A dense optimizer
over a production-size table (Criteo-full: an ``(8,100,032, 16)`` fused
table) moves every row every step to update the few thousand a batch
touched; these updates move only those rows.

- :func:`sparse_sgd_update`: one ``index_add_`` into the table, which a
  dense SGD step equals (duplicate ids add up, untouched rows stay).
- :func:`rowwise_adagrad_update`: one accumulator scalar per row, the mean
  of the squared gradient; duplicate ids of a batch are summed first, so the
  accumulator sees each row once a step.

The gradients of the gathered rows come from :class:`RowRecorder`: inside
:func:`record_rows` a table's gather hook (``EmbeddingCollection``'s fused
gather, HSTU's untied token table, the sampled softmax's candidate rows)
reads the rows of the detached table into a leaf that requires grad and
records ``(table name, ids, leaf)``.  After ``backward`` each leaf holds
``d loss / d rows``; the table itself takes no gradient, so no dense
``(V, D)`` gradient is formed.  A read of an owned table outside the hooks
(:func:`outside_hooks`) takes no gradient, as in the JAX package.

Ids are recorded as the JAX package sows them: unwrapped (``ids + offset``
in a fused table, possibly negative).  The dedup runs on those, and they
are wrapped (a negative id counts from the end of the table) only where
rows are read or written.  None of the updates reads a value back to the
host: the dedup is ``torch.sort``, boundary flags, ``cumsum`` and
``scatter_``, never ``torch.unique``, whose data-dependent size would.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterable, Iterator, List, Mapping, Tuple

import torch
import torch.nn.functional as F

from ..parallel.mesh import row_shard, table_rows

TABLE_PREFIX = "fused_d"
TABLE_SUFFIX = "_table"


def is_fused_table_key(name) -> bool:
    """Whether a parameter's (last) name is a fused table's, ``fused_d{D}_table``."""
    if not isinstance(name, str):
        return False
    leaf = name.rsplit(".", 1)[-1]
    return leaf.startswith(TABLE_PREFIX) and leaf.endswith(TABLE_SUFFIX)


def split_fused_tables(named_parameters: Iterable[Tuple[str, torch.Tensor]], extra_names: Tuple[str, ...] = ()) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """``(sparse tables, everything else)`` of ``module.named_parameters()``, both ``{name: parameter}``.

    The sparse tables are the fused ``fused_d{D}_table`` parameters and any
    parameter whose last name is in ``extra_names`` (a model's named table
    with a gather hook, e.g. HSTU's untied ``token_embedding``).
    """
    tables, rest = {}, {}
    for name, p in named_parameters:
        leaf = name.rsplit(".", 1)[-1]
        (tables if is_fused_table_key(leaf) or leaf in extra_names else rest)[name] = p
    return tables, rest


def _wrap(ids: torch.Tensor, rows: int) -> torch.Tensor:
    """Row indices of ``ids`` as ``jnp.take`` and ``.at[]`` read them: a negative id counts from the end."""
    return torch.where(ids < 0, ids + rows, ids)


def unique_with_fill(ids: torch.Tensor, fill: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jnp.unique(ids, size=n, fill_value=fill, return_inverse=True)`` for 1-D ``ids`` of ``n`` elements.

    ``u`` holds the sorted distinct ids, then ``fill`` up to ``n``; ``inv``
    maps each id to its slot in ``u``.  An id equal to ``fill`` is a
    distinct id of its own, sorted among the others.  No host synchronisation.
    """
    n = ids.shape[0]
    sorted_ids, order = torch.sort(ids)
    first = torch.ones(n, dtype=torch.bool, device=ids.device)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    slot = torch.cumsum(first, 0) - 1
    u = torch.full((n,), fill, dtype=ids.dtype, device=ids.device).scatter_(0, slot, sorted_ids)
    inv = torch.empty_like(slot).scatter_(0, order, slot)
    return u, inv


@torch.no_grad()
def sparse_sgd_update(table: torch.Tensor, flat_ids: torch.Tensor, flat_grads: torch.Tensor, lr, weight_decay: float = 0.0) -> torch.Tensor:
    """SGD on the touched rows, in place: ``W[ids] -= lr * g`` by one ``index_add_``.

    A dense SGD step gives the same table (duplicates add up as a dense
    gradient's would).  ``weight_decay`` decays the touched rows lazily, once
    per occurrence of an id, from the rows before the step.  On a row shard
    (``parallel.mesh.RowShard``) the ids are the whole table's and only the
    shard's own rows move.
    """
    shard = row_shard(table)
    rows = _wrap(flat_ids.reshape(-1).to(torch.int64), table.shape[0] if shard is None else shard.rows)
    grads = flat_grads.reshape(rows.shape[0], flat_grads.shape[-1])
    if shard is not None:
        rows, owned = shard.own(rows, table.shape[0])
        grads = grads * owned[:, None].to(grads.dtype)
    decay = table.index_select(0, rows) if weight_decay else None
    if weight_decay and shard is not None:
        decay = decay * owned[:, None].to(decay.dtype)
    table.index_add_(0, rows, (-lr * grads).to(table.dtype))
    if weight_decay:
        table.index_add_(0, rows, (-lr * weight_decay * decay).to(table.dtype))
    return table


@torch.no_grad()
def rowwise_adagrad_update(table: torch.Tensor, accum: torch.Tensor, flat_ids: torch.Tensor, flat_grads: torch.Tensor, lr, eps: float = 1e-10, weight_decay: float = 0.0, spare_row: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise Adagrad on the touched rows, with the batch's duplicate ids summed first; in place.

    Args:
        table: ``(R, D)`` table; accum: ``(R,)`` fp32 accumulators of the
            rows' mean squared gradients.
        flat_ids: ``(N,)`` row ids as recorded (duplicates allowed, negative
            ids count from the end); flat_grads: ``(N, D)`` ``d loss / d rows``.
        spare_row: the dedup's fill row; the table's last row by default,
            which a fused table always leaves spare.  A recorded id equal to
            it is treated as fill: its row and accumulator do not change.

    On a row shard (``parallel.mesh.RowShard``) ``table`` and ``accum`` are the
    shard's, the ids and ``spare_row`` the whole table's; the dedup runs
    over every id, and only the shard's own rows and accumulators move.

    Per distinct id ``u`` with summed gradient ``s``: ``accum[u] += mean(s²)``,
    then ``W[u] -= lr / (sqrt(accum[u]) + eps) · s`` (plus
    ``lr · weight_decay · W[u]`` from the rows before the step).
    Returns ``(table, accum)``.
    """
    ids = flat_ids.reshape(-1).to(torch.int64)
    n = ids.shape[0]
    grads = flat_grads.reshape(n, flat_grads.shape[-1])
    shard = row_shard(table)
    total = table.shape[0] if shard is None else shard.rows
    fill = total - 1 if spare_row < 0 else spare_row
    u, inv = unique_with_fill(ids, fill)
    seg = torch.zeros((n, grads.shape[1]), dtype=grads.dtype, device=grads.device).index_add_(0, inv, grads)
    valid = u != fill
    rows = _wrap(u, total)
    if shard is not None:
        rows, owned = shard.own(rows, table.shape[0])
        valid = valid & owned
    valid = valid.to(table.dtype)
    accum.index_add_(0, rows, torch.mean(seg * seg, dim=-1) * valid)
    scale = lr / (torch.sqrt(accum.index_select(0, rows)) + eps) * valid
    upd = -scale[:, None] * seg
    if weight_decay:
        upd = upd - (lr * weight_decay * valid)[:, None] * table.index_select(0, rows)
    table.index_add_(0, rows, upd.to(table.dtype))
    return table, accum


def init_accumulators(tables: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """fp32 ``(R,)`` zeros for each table, on its device."""
    return {name: torch.zeros(t.shape[0], dtype=torch.float32, device=t.device) for name, t in tables.items()}


class RowRecorder:
    """Collects ``(table name, ids, rows leaf)`` from the gather hooks of the tables it owns."""

    def __init__(self, tables: Mapping[str, torch.Tensor]):
        self.names = {id(t): name for name, t in tables.items()}
        self.records: List[Tuple[str, torch.Tensor, torch.Tensor]] = []

    def owns(self, table: torch.Tensor) -> bool:
        return id(table) in self.names

    def gather(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """``table[ids]`` as a leaf that takes the rows' gradient; ``ids`` are recorded unwrapped.

        A row shard's leaf holds the whole table's rows (``RowShard.read``).
        """
        shard = row_shard(table)
        rows = (F.embedding(_wrap(ids, table.shape[0]), table.detach()) if shard is None else shard.read(table.detach(), ids)).requires_grad_()
        self.records.append((self.names[id(table)], ids, rows))
        return rows


# the open recorder of this thread, as torch's grad mode is per thread
_STATE = threading.local()


def gather_rows(table: torch.Tensor, ids: torch.Tensor, gather=None) -> torch.Tensor:
    """``table[ids]`` at a table's gather hook.

    Inside a :func:`record_rows` of this thread that owns ``table``, the
    recorded leaf (:meth:`RowRecorder.gather`); else ``gather(table, ids)``,
    plain indexing (of a row shard's whole table) by default.
    """
    rec = getattr(_STATE, "recorder", None)
    if rec is not None and rec.owns(table):
        return rec.gather(table, ids)
    return table_rows(table, ids) if gather is None else gather(table, ids)


def outside_hooks(table: torch.Tensor) -> torch.Tensor:
    """``table`` for a read outside the gather hooks (a tower that indexes it directly).

    Inside a :func:`record_rows` of this thread that owns ``table``, the
    detached table: the JAX package's sparse step takes the table's
    gradient from the hooks only and drops such a read's, and no dense
    ``(V, D)`` gradient forms.  Else ``table`` as it is.
    """
    rec = getattr(_STATE, "recorder", None)
    return table.detach() if rec is not None and rec.owns(table) else table


@contextlib.contextmanager
def record_rows(tables: Mapping[str, torch.Tensor]) -> Iterator[RowRecorder]:
    """Open a :class:`RowRecorder` for ``tables`` (``{name: parameter}``) around a forward."""
    rec, prev = RowRecorder(tables), getattr(_STATE, "recorder", None)
    _STATE.recorder = rec
    try:
        yield rec
    finally:
        _STATE.recorder = prev


def pair_sparse_grads(records) -> Iterator[Tuple[str, torch.Tensor, torch.Tensor]]:
    """``(table name, flat ids (N,), flat row gradients (N, D))`` of each record after ``backward``.

    A leaf the loss did not reach has no gradient: its rows' gradient is 0.
    """
    for name, ids, rows in records:
        grad = rows.grad if rows.grad is not None else torch.zeros_like(rows)
        yield name, ids.reshape(-1), grad.reshape(-1, rows.shape[-1])
