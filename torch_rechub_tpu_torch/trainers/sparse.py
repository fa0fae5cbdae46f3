"""The sparse row-wise embedding updates of the trainers (``sparse_embedding="sgd" | "adagrad"``).

Counterpart of ``torch_rechub_tpu/trainers/sparse.py``.  The sparse tables
(the fused ``fused_d{D}_table`` parameters, and named tables such as HSTU's
untied ``token_embedding``) leave the dense optimizer: it is built over
the other parameters only (Adam, or Adam and the ``embedding_optimizer``
table rule for the per-feature tables), and the sparse tables take no Adam
state and no weight decay.  ``TorchTrainer.train_step`` runs the loss with
a :func:`~torch_rechub_tpu_torch.ops.sparse_update.record_rows` recorder
open over them, ``backward``, the dense optimizer, then
:func:`apply_sparse_table_updates` at the same learning rate.  With no
sparse tables the recorder owns nothing and that step is the dense one.

A tied output projection (``tie_embeddings=True``) gives the token table a
dense gradient through the logits, every row every step: there is nothing
sparse to take, and leaving the table out of the gradient would drop that
part, so ``SeqTrainer`` refuses it.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import torch

from ..ops import sparse_update as su
from ..parallel.distributed import all_gather


def validate_method(method):
    if method not in (None, "sgd", "adagrad"):
        raise ValueError(f"sparse_embedding must be None|'sgd'|'adagrad', got {method!r}")
    return method


def init_sparse_opt_state(model: torch.nn.Module, extra_names: Tuple[str, ...] = ()) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], List[Tuple[str, torch.Tensor]]]:
    """``(sparse tables, their accumulators, the rest)`` of ``model``.

    The tables are ``{name: parameter}``, the accumulators fp32 ``(R,)``
    zeros per table, the rest the ``(name, parameter)`` pairs the dense
    optimizer is built over.  Raises a ``ValueError`` when the model has no
    sparse-capable table.
    """
    tables, rest = su.split_fused_tables(model.named_parameters(), extra_names)
    if not tables:
        raise ValueError(
            "sparse_embedding found no sparse-capable tables in this model "
            f"(looked for fused 'fused_d*_table' parameters and named tables {list(extra_names)}). "
            "For EmbeddingCollection models the default 'auto' layout only fuses tables with "
            ">=262144 rows: call torch_rechub_tpu_torch.ops.embedding.set_fused_default(True) "
            "before building the model to fuse everything."
        )
    return tables, su.init_accumulators(tables), list(rest.items())


def apply_sparse_table_updates(tables: Mapping[str, torch.Tensor], accums: Dict[str, torch.Tensor], records, method: Optional[str], lr, spare_rows: Optional[Mapping[str, int]] = None, data_group=None) -> None:
    """Group the recorded row gradients by table and update each table once, in place.

    Every call site of one table (e.g. the sampled softmax's label rows and
    its negatives) is concatenated first, so Adagrad dedups them together.
    ``spare_rows`` maps a table's last name to its dedup fill row (fused
    tables use their spare last row).  A named table's fill row must take no
    update, e.g. HSTU's PAD row 0, masked out of the forward.  No records,
    no update.

    Under a mesh (``data_group``, the trainer's data group) each call site's
    ids and row gradients are first gathered over the data group, in data
    order, so the dedup runs over the global batch; a row-shard table then
    updates its own rows (``ops/sparse_update.py``).
    """
    spare_rows = spare_rows or {}
    by_table: Dict[str, list] = {}
    for name, ids, grads in su.pair_sparse_grads(records):
        if data_group is not None:
            ids, grads = all_gather(ids, data_group), all_gather(grads, data_group)
        by_table.setdefault(name, []).append((ids, grads))
    for name, parts in by_table.items():
        ids = torch.cat([p[0].to(torch.int64) for p in parts])
        grads = torch.cat([p[1] for p in parts])
        if method == "sgd":
            su.sparse_sgd_update(tables[name], ids, grads, lr)
        else:
            su.rowwise_adagrad_update(tables[name], accums[name], ids, grads, lr, spare_row=spare_rows.get(name.rsplit(".", 1)[-1], -1))
