"""Streaming Parquet input pipeline, and batches copied to the card ahead of use.

Counterpart of ``torch_rechub_tpu/data/dataset.py``: ``ParquetIterableDataset``
reads dict-of-numpy batches from Parquet files with the same batch boundaries
(``shard(num_shards, index)`` splits the files into contiguous parts, one per
host or worker), and ``prefetch_to_device`` keeps ``size`` batches in flight to
the device so the copy of the next batch overlaps the step on this one.
``pyarrow`` is imported where it is used.
"""

from __future__ import annotations

import collections
import glob as globlib
import itertools
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..parallel.mesh import BatchSharding
from .convert import pa_array_to_numpy


class ParquetIterableDataset:
    """Iterate dict-of-numpy batches from (many) parquet files.

    Args:
        file_paths: list of paths or a glob pattern.
        batch_size: rows per yielded batch.
        columns: columns to read (None = all).
        label_col: if set, batches are ``(x_dict, y)`` tuples.
        dtype_map: optional per-column numpy dtype overrides.
    """

    def __init__(self, file_paths, batch_size: int = 1024, columns: Optional[Sequence[str]] = None, label_col: Optional[str] = None, dtype_map: Optional[Dict] = None):
        if isinstance(file_paths, str):
            file_paths = sorted(globlib.glob(file_paths))
        self.file_paths: List[str] = list(file_paths)
        if not self.file_paths:
            raise ValueError("no parquet files matched")
        self.batch_size = batch_size
        self.columns = list(columns) if columns is not None else None
        self.label_col = label_col
        self.dtype_map = dtype_map or {}
        self._shard = (1, 0)

    def shard(self, num_shards: int, index: int) -> "ParquetIterableDataset":
        """Contiguous file partition for worker/host ``index`` of ``num_shards``."""
        if not (0 <= index < num_shards):
            raise ValueError(f"index {index} out of range for {num_shards} shards")
        out = ParquetIterableDataset(self.file_paths, self.batch_size, self.columns, self.label_col, self.dtype_map)
        out._shard = (num_shards, index)
        return out

    def _my_files(self) -> List[str]:
        n, i = self._shard
        per = (len(self.file_paths) + n - 1) // n
        return self.file_paths[i * per:(i + 1) * per]

    def _convert(self, table):
        return {name: pa_array_to_numpy(table.column(name), dtype=self.dtype_map.get(name, np.float32)) for name in table.column_names}

    def __iter__(self) -> Iterator:
        import pyarrow as pa
        import pyarrow.parquet as pq

        buffer: Dict[str, List[np.ndarray]] = collections.defaultdict(list)
        buffered = 0

        def flush(n):
            nonlocal buffered
            batch = {k: np.concatenate(v)[:n] for k, v in buffer.items()}
            rest = {k: np.concatenate(v)[n:] for k, v in buffer.items()}
            buffer.clear()
            for k, v in rest.items():
                if len(v):
                    buffer[k].append(v)
            buffered = len(next(iter(rest.values()))) if rest else 0
            if self.label_col is not None:
                y = batch.pop(self.label_col)
                return batch, y
            return batch

        for path in self._my_files():
            for record_batch in pq.ParquetFile(path).iter_batches(batch_size=self.batch_size, columns=self.columns):
                arrs = self._convert(pa.Table.from_batches([record_batch]))
                n_rows = len(next(iter(arrs.values())))
                for k, v in arrs.items():
                    buffer[k].append(v)
                buffered += n_rows
                while buffered >= self.batch_size:
                    yield flush(self.batch_size)
        if buffered > 0:
            yield flush(buffered)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [] if tree is None else [tree]


def prefetch_to_device(iterator, size: int = 2, sharding=None, device=None):
    """Yield the batches of ``iterator`` (trees of dicts, lists and tuples of arrays) as tensors on ``device``,
    copied ``size`` batches ahead of use; ``device`` is the card unless the caller names another.

    On a CUDA device a batch's arrays are packed into one pinned host buffer
    (each at a 16-byte aligned offset) and copied to the card in one
    ``non_blocking`` copy on a copy stream of its own, so the copy overlaps
    the work the consumer enqueues meanwhile (a ``non_blocking`` copy from
    pageable memory would be synchronous); the batch's tensors are views of
    the device buffer, in the arrays' dtypes and shapes.  One copy instead
    of one per array keeps the host's work per batch small.  Before a batch
    is handed over, the consumer's stream waits for its copy's event, and
    the device buffer is marked as used on that stream (``record_stream``),
    so the allocator does not hand its memory to the copy stream again while
    the consumer still reads it.  Values and order are the iterator's.
    ``sharding`` (``parallel.mesh.batch_sharding`` / ``scan_batch_sharding``
    of a mesh) keeps this rank's rows of each array, before the packing: only
    they are copied.
    """
    if sharding is not None:
        if not isinstance(sharding, BatchSharding):
            raise TypeError(f"sharding must be a parallel.mesh.BatchSharding (batch_sharding(mesh) / scan_batch_sharding(mesh)) or None, got {type(sharding).__name__}")
        iterator = (_tree_map(sharding.local, batch) for batch in iterator)
    if size < 1:
        raise ValueError(f"prefetch_to_device needs size >= 1, got {size}")
    from ..trainers.base import resolve_device  # the trainers import this module

    device = resolve_device(device)
    queue = collections.deque()
    if device.type == "cuda":
        copy_stream = torch.cuda.Stream(device)

        def put(batch):
            arrays = [np.ascontiguousarray(a) for a in _leaves(batch)]
            offsets = np.cumsum([0] + [-(-a.nbytes // 16) * 16 for a in arrays])
            host = torch.empty(int(offsets[-1]), dtype=torch.uint8, pin_memory=True)
            staging = host.numpy()
            for a, off in zip(arrays, offsets):
                staging[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
            with torch.cuda.stream(copy_stream):
                buffer = host.to(device, non_blocking=True)
                done = torch.cuda.Event()
                done.record(copy_stream)
            views = iter([buffer[off:off + a.nbytes].view(torch.from_numpy(a[:0].reshape(-1)).dtype).view(a.shape) for a, off in zip(arrays, offsets)])
            queue.append((_tree_map(lambda a: next(views), batch), buffer, done, host))  # the pinned buffer lives until its batch is handed over

        def take():
            out, buffer, done, _host = queue.popleft()
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            buffer.record_stream(consumer)
            return out
    else:
        def put(batch):
            queue.append(_tree_map(lambda a: torch.as_tensor(np.asarray(a), device=device), batch))

        take = queue.popleft

    it = iter(iterator)
    for batch in itertools.islice(it, size):
        put(batch)
    while queue:
        yield take()
        for batch in itertools.islice(it, 1):
            put(batch)
