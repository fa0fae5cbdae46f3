"""The (data, model) mesh of ranks and its placement rules.

Counterpart of ``torch_rechub_tpu/parallel/mesh.py``.  There, one
``jax.sharding.Mesh`` with ``("data", "model")`` axes: batches shard over
``data``, embedding tables row-shard over ``model``, dense parameters
replicate, and XLA inserts the collectives.  Here the mesh is a grid of
``torch.distributed`` ranks, one device each (``parallel/distributed.py``
brings them up), laid out as the JAX package lays out devices: rank
``d * model + m`` sits at ``(d, m)``.

- Every rank reads the same global batch and keeps its data index's
  contiguous rows (:func:`shard_batch`, :class:`BatchSharding`).  Ranks that
  share a data index (a "model group") compute the same dense work on the
  same rows, as devices on JAX's ``model`` axis do.
- Dense parameters and buffers are replicated: :func:`shard_params`
  broadcasts them from rank 0.  The trainers sum their gradients over the
  data group (``distributed.all_reduce_gradients``).
- A table that :func:`plan_table_placement` marks ``"shard"`` keeps rows
  ``[m·R/M, (m+1)·R/M)`` on the ranks of model index ``m``; the parameter
  carries a :class:`RowShard`.  A read of its rows (:func:`table_rows`) takes
  each owner's rows, zeros elsewhere, and sums them over the model group;
  its gradient reaches the owner's rows only.  The trainers sum a shard's
  gradient over the data group too.

``mesh=None`` leaves everything as it is.  The policy functions
(:func:`plan_table_placement`, :func:`param_shardings`) read only
``mesh.shape``, so they run without a process group.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import distributed as pd

DATA_AXIS = "data"
MODEL_AXIS = "model"

# Tables at least this many rows row-shard over the model axis whenever
# n_model > 1.  EmbeddingCollection pads tables >= this size to a multiple of
# 64 rows, so divisibility holds for any model axis that divides 64; a
# non-power-of-two axis need not divide a 64-multiple and such tables fall
# back to replicate with a warning naming them.
SHARD_MIN_ROWS = 65536

# Replicated-table memory budget per device.  When the tables chosen to
# replicate exceed it, the policy force-shards the largest divisible ones
# until the remainder fits.
DEFAULT_TABLE_HBM_BUDGET = 2 << 30


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """How many mesh slots per axis; ``data * model`` must equal the world size."""

    data: int
    model: int = 1


class DeviceMesh:
    """A ``(data, model)`` grid of ranks and the process groups of its two axes.

    ``devices`` is the ``(data, model)`` array of ranks, ``shape`` is
    ``{"data": d, "model": m}`` (the JAX package reads ``mesh.shape["data"]``),
    ``size`` and ``axis_names`` as a ``jax.sharding.Mesh``'s.  This rank sits at
    ``(data_index, model_index)``; ``data_group`` holds the ranks of its model
    index (the ranks a batch is split over), ``model_group`` those of its data
    index (the ranks a table's rows are split over).
    """

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, ranks: np.ndarray):
        self.devices = ranks
        d, m = ranks.shape
        self.shape = {DATA_AXIS: d, MODEL_AXIS: m}
        self.size = d * m
        (self.data_index, self.model_index), = np.argwhere(ranks == dist.get_rank())
        self.data_index, self.model_index = int(self.data_index), int(self.model_index)
        self.backend = dist.get_backend()
        # every rank creates every group, in the same order (torch.distributed's rule)
        for col in range(m):
            g = dist.new_group(ranks[:, col].tolist())
            if col == self.model_index:
                self.data_group = g
        for row in range(d):
            g = dist.new_group(ranks[row, :].tolist())
            if row == self.data_index:
                self.model_group = g

    def group(self, axis: str):
        return {DATA_AXIS: self.data_group, MODEL_AXIS: self.model_group}[axis]

    def __repr__(self):
        return f"DeviceMesh(data={self.shape[DATA_AXIS]}, model={self.shape[MODEL_AXIS]}, {self.backend}, rank at ({self.data_index}, {self.model_index}))"


def create_mesh(data: Optional[int] = None, model: int = 1, devices=None) -> DeviceMesh:
    """Build a ``(data, model)`` mesh over the world's ranks (``devices``: the ranks, by default all, in order).

    Needs the process group up (``distributed.initialize`` or ``spawn``); every
    rank calls it, with the same arguments.
    """
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs torch.distributed: call torch_rechub_tpu_torch.parallel.distributed.initialize(...) (or run under torchrun / distributed.spawn) first")
    world = dist.get_world_size()
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    if ranks != list(range(world)):
        raise ValueError(f"a mesh covers the whole world in rank order: got ranks {ranks} of a world of {world}")
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} devices")
    return DeviceMesh(np.array(ranks).reshape(data, model))


def check_mesh(mesh) -> Optional[DeviceMesh]:
    """``mesh`` if it is None or a :class:`DeviceMesh`; anything else raises a ``TypeError``."""
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a parallel.mesh.DeviceMesh (parallel.create_mesh) or None, got {type(mesh).__name__}")
    return mesh


def _data_rows(n: int, mesh) -> slice:
    d = mesh.shape[DATA_AXIS]
    if n % d:
        raise ValueError(f"a batch of {n} rows does not split over a data axis of {d}")
    b = n // d
    return slice(mesh.data_index * b, (mesh.data_index + 1) * b)


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """Which rows of a batch this rank keeps: along ``axis`` (None: all of them) its data index's block."""

    mesh: DeviceMesh
    axis: Optional[int]

    def local(self, x):
        """This rank's block of a numpy array or tensor."""
        if self.axis is None:
            return x
        rows = _data_rows(x.shape[self.axis], self.mesh)
        return x[(slice(None),) * self.axis + (rows,)]


def batch_sharding(mesh: Optional[DeviceMesh]) -> Optional[BatchSharding]:
    """Sharding for a per-step batch: the leading (batch) dim over the data axis."""
    return None if mesh is None else BatchSharding(mesh, 0)


def scan_batch_sharding(mesh: Optional[DeviceMesh]) -> Optional[BatchSharding]:
    """Sharding for stacked multi-step batches ``(n_steps, batch, ...)``: the batch axis over data."""
    return None if mesh is None else BatchSharding(mesh, 1)


def replicated_sharding(mesh: Optional[DeviceMesh]) -> Optional[BatchSharding]:
    return None if mesh is None else BatchSharding(mesh, None)


# ---------------------------------------------------------------------------
# Table placement policy
# ---------------------------------------------------------------------------


def plan_table_placement(table_shapes, n_model: int, hbm_budget_bytes: int = DEFAULT_TABLE_HBM_BUDGET, dtype_bytes: int = 4, shard_min_rows: Optional[int] = None, force_shard=()):
    """Decide shard-vs-replicate for every embedding table, budget-aware.

    Args:
        table_shapes: ``{name: (rows, dim)}`` for every embedding table.
        n_model: size of the model mesh axis.
        hbm_budget_bytes: per-device budget for REPLICATED table bytes.
        dtype_bytes: bytes per element (4 = f32 tables).
        shard_min_rows: rows at which a table always shards (n_model > 1).
        force_shard: names that shard regardless of size (fused tables — they
            exist to be sharded and are padded divisible by construction).

    Returns:
        ``{name: "shard" | "replicate"}``.  Rules, in order:
        1. ``n_model == 1`` → everything replicates (nothing to shard over).
        2. ``force_shard`` members and tables with rows >= shard_min_rows,
           rows divisible by n_model → shard.
        3. Remaining tables replicate — unless their total exceeds the
           budget, in which case the largest divisible ones shard (floor:
           8 * n_model rows) until the remainder fits.
        A table that must stay replicated only because its rows don't divide
        ``n_model`` triggers a warning naming it; ``EmbeddingCollection``
        avoids this by padding big tables to a multiple of 64 rows.
    """
    if shard_min_rows is None:
        shard_min_rows = SHARD_MIN_ROWS  # late-bound: module attr, patchable
    if n_model <= 1:
        return {name: "replicate" for name in table_shapes}
    plan = {}
    replicated = []
    force = set(force_shard)
    for name, (rows, dim) in table_shapes.items():
        if (name in force or rows >= shard_min_rows) and rows % n_model == 0 and rows >= n_model:
            plan[name] = "shard"
        else:
            if rows >= shard_min_rows or name in force:
                warnings.warn(f"table {name!r} ({rows} rows) stays replicated: rows not divisible by model axis {n_model} — pad to a multiple of {n_model} (EmbeddingCollection pads tables >= {shard_min_rows} rows automatically)")
            plan[name] = "replicate"
            replicated.append((rows * dim * dtype_bytes, rows, name))
    # budget pass: force-shard the largest replicated-but-divisible tables
    over = sum(b for b, _, _ in replicated) - hbm_budget_bytes
    if over > 0:
        for bytes_, rows, name in sorted(replicated, reverse=True):
            if over <= 0:
                break
            if rows % n_model == 0 and rows >= 8 * n_model:
                plan[name] = "shard"
                over -= bytes_ * (n_model - 1) // n_model
    return plan


def table_partition_spec(vocab_size: int, mesh: Optional[DeviceMesh]) -> Tuple:
    """Single-table convenience wrapper over :func:`plan_table_placement`: ``("model", None)`` (rows over the model
    axis) or ``()`` (replicated), as the JAX package's ``PartitionSpec``."""
    if mesh is None:
        return ()
    plan = plan_table_placement({"t": (vocab_size, 1)}, mesh.shape[MODEL_AXIS], dtype_bytes=4)
    return (MODEL_AXIS, None) if plan["t"] == "shard" else ()


def _is_table_path(name: str) -> bool:
    """Embedding-table parameters by name, the JAX package's contract on the port's names: ``EmbeddingCollection``
    names every table ``*_table``, model-local embeddings carry ``embedding`` in their name (HSTU's
    ``token_embedding``), and an untied generative ``output_projection`` is a vocab-row table too."""
    p = name.lower()
    return "embedding" in p or p.endswith("_table") or p.rsplit(".", 1)[-1] == "output_projection"


def _named_parameters(params) -> Iterable[Tuple[str, torch.Tensor]]:
    return params.named_parameters() if isinstance(params, torch.nn.Module) else (params.items() if isinstance(params, Mapping) else params)


def param_shardings(params, mesh: Optional[DeviceMesh], hbm_budget_bytes: int = DEFAULT_TABLE_HBM_BUDGET) -> Dict[str, Optional[str]]:
    """``{parameter name: "shard" | "replicate"}`` of a module (or ``{name: tensor}``): tables placed by
    :func:`plan_table_placement`, everything else replicated; every value None without a mesh."""
    named = list(_named_parameters(params))
    if mesh is None:
        return {name: None for name, _ in named}
    table_shapes = {name: tuple(p.shape) for name, p in named if _is_table_path(name) and p.ndim == 2}
    # fused tables always shard: padded divisible by construction, and the
    # fused layout exists precisely to row-shard / take sparse updates
    force = tuple(k for k in table_shapes if "fused_d" in k and k.endswith("_table"))
    plan = plan_table_placement(table_shapes, mesh.shape[MODEL_AXIS], hbm_budget_bytes=hbm_budget_bytes, force_shard=force)
    return {name: plan.get(name, "replicate") for name, _ in named}


# ---------------------------------------------------------------------------
# row-sharded tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class RowShard:
    """Rows ``[start, start + local)`` of a ``rows``-row table, held by each rank of the model group ``group`` at
    its model index (the rows split evenly in model order)."""

    rows: int
    start: int
    group: object

    def own(self, rows: torch.Tensor, local_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(local row, owned)`` of whole-table rows (``>= 0``) on a shard of ``local_rows`` rows: another owner's
        row maps to row 0 with ``owned`` False, so that a read or an update of it is multiplied away."""
        local = rows - self.start
        owned = (local >= 0) & (local < local_rows)
        return torch.where(owned, local, 0), owned

    def read(self, shard: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """``table[ids]`` of the whole table (a negative id counts from its end): each owner's rows, zeros
        elsewhere, summed over the model group.  The gradient reaches ``shard``'s own rows only."""
        local, owned = self.own(torch.where(ids < 0, ids + self.rows, ids).to(torch.int64), shard.shape[0])
        part = F.embedding(local, shard) * owned[..., None].to(shard.dtype)
        return pd.sum_replicated(part, self.group)

    def gather(self, shard: torch.Tensor) -> torch.Tensor:
        """The whole table (every owner's rows, in order); the gradient reaches ``shard``'s rows."""
        return pd.gather_replicated(shard, self.group, 0)

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole-table tensor (``(rows, ...)``)."""
        n = self.rows // dist.get_world_size(self.group)
        return full[self.start: self.start + n]


def row_shard(t) -> Optional[RowShard]:
    """The :class:`RowShard` a table tensor carries, or None for a whole one."""
    return getattr(t, "row_shard", None)


def with_row_shard(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` (a row-wise function of ``like``, e.g. its L2-normalised rows) marked with ``like``'s :class:`RowShard`."""
    shard = row_shard(like)
    if shard is not None:
        t.row_shard = shard
    return t


def table_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for a whole table or a row shard (:meth:`RowShard.read`)."""
    shard = row_shard(table)
    return table[ids] if shard is None else shard.read(table, ids)


def _owner(model: torch.nn.Module, name: str) -> Tuple[torch.nn.Module, str]:
    module_name, _, leaf = name.rpartition(".")
    return model.get_submodule(module_name), leaf


def _broadcast_flat(tensors, src: int, group=None) -> None:
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        pd.broadcast_(flat, src, group)
        offset = 0
        with torch.no_grad():
            for t in ts:
                t.copy_(flat[offset: offset + t.numel()].view_as(t))
                offset += t.numel()


def shard_params(params: torch.nn.Module, mesh: Optional[DeviceMesh]) -> torch.nn.Module:
    """Place the parameters of the module ``params`` on the mesh, in place, by :func:`param_shardings` (the JAX
    package's argument is the parameter pytree; here the module that holds them): each sharded table keeps
    this rank's rows (equal to those of data index 0, which are broadcast over the data group) and carries a
    :class:`RowShard`; the rest, and the buffers, are broadcast from rank 0.

    A table may shard only where its module reads it through
    :func:`table_rows` (its ``row_shardable`` names); another raises.
    """
    if mesh is None:
        return params
    model = params
    plan = param_shardings(model, mesh)
    n_model = mesh.shape[MODEL_AXIS]
    replicated, shards = [], []
    for name, p in model.named_parameters():
        if plan[name] != "shard":
            replicated.append(p)
            continue
        module, leaf = _owner(model, name)
        if leaf not in getattr(module, "row_shardable", ()):
            raise NotImplementedError(f"{name} ({tuple(p.shape)}) would row-shard over the model axis, but {type(module).__name__} reads it directly: only "
                                      "EmbeddingCollection's tables and HSTU's token_embedding / output_projection are read through table_rows")
        n = p.shape[0] // n_model
        shard = RowShard(rows=p.shape[0], start=mesh.model_index * n, group=mesh.model_group)
        p.data = p.data[shard.start: shard.start + n].clone()
        p.row_shard = shard
        shards.append(p)
    _broadcast_flat(replicated + list(model.buffers()), src=int(mesh.devices.flat[0]))
    _broadcast_flat(shards, src=int(mesh.devices[0, mesh.model_index]), group=mesh.data_group)
    return model


def shard_batch(batch, mesh: Optional[DeviceMesh]):
    """This rank's rows of a batch (a dict, list or tuple of arrays or tensors, batch axis first)."""
    if mesh is None:
        return batch
    sharding = batch_sharding(mesh)
    if isinstance(batch, Mapping):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    return None if batch is None else sharding.local(batch)


def unshard(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` (a tensor of ``like``'s shape, e.g. a parameter's Adam moment) as a whole table when ``like`` is a row
    shard, gathered over its model group; else ``t``."""
    shard = row_shard(like)
    return t if shard is None or t.shape[:1] != like.shape[:1] else pd.all_gather(t, shard.group)


def reshard(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a whole-table ``full`` when ``like`` is a row shard (``full`` has the whole table's rows);
    else ``full``."""
    shard = row_shard(like)
    return full if shard is None or full.shape[:1] != (shard.rows,) else shard.local(full)
