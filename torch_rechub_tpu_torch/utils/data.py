"""Minibatch iterators and data helpers, as in ``torch_rechub_tpu/utils/data.py``.

Batches are dicts of numpy arrays (``ArrayLoader``, ``SeqLoader``), which
the trainers move to their device, or stacked tensors already on the card
(``DeviceCachedLoader``).  A trainer pads a partial batch to the loader's
``batch_size`` with ``pad_batch`` and weighs the padding rows 0.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch


def df_to_dict(df) -> Dict[str, np.ndarray]:
    """A DataFrame as ``{column: np.ndarray}``."""
    return {col: df[col].to_numpy() for col in df.columns}


def _check_lengths(x: Dict[str, np.ndarray], y: Optional[np.ndarray]) -> int:
    lengths = {len(v) for v in x.values()}
    if len(lengths) != 1:
        raise ValueError(f"inconsistent feature lengths: {lengths}")
    n = lengths.pop()
    if y is not None and len(y) != n:
        raise ValueError("labels length mismatch")
    return n


class ArrayLoader:
    """Minibatch iterator over a dict-of-arrays dataset.

    Yields ``(x_batch, y_batch)`` (or ``x_batch`` without labels), shuffled
    per epoch from ``seed + epoch`` when ``shuffle``.  The last batch may be
    partial.
    """

    def __init__(self, x: Dict[str, np.ndarray], y: Optional[np.ndarray] = None, batch_size: int = 256, shuffle: bool = False, seed: int = 0, drop_last: bool = False):
        self.x = {k: np.asarray(v) for k, v in x.items()}
        self.y = None if y is None else np.asarray(y)
        self.n = _check_lengths(self.x, self.y)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    @property
    def dataset_size(self) -> int:
        return self.n

    def first_batch(self):
        """The leading batch, unshuffled."""
        idx = np.arange(min(self.batch_size, self.n))
        x = {k: v[idx] for k, v in self.x.items()}
        return (x, self.y[idx]) if self.y is not None else x

    def __iter__(self) -> Iterator:
        order = np.arange(self.n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
            self._epoch += 1
        for start in range(0, self.n, self.batch_size):
            idx = order[start:start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            x = {k: v[idx] for k, v in self.x.items()}
            if self.y is not None:
                yield x, self.y[idx]
            else:
                yield x


def pad_batch(x: Dict[str, np.ndarray], y: Optional[np.ndarray], batch_size: int) -> Tuple[Dict[str, np.ndarray], Optional[np.ndarray], np.ndarray]:
    """Pad a (possibly partial) batch to ``batch_size``; returns a 0/1 weight per row.

    The padding CYCLES the real rows: zero-weight rows never enter the loss,
    but BatchNorm's batch statistics are unweighted, and cycled rows keep
    them close to the real rows' statistics.
    """
    n = len(next(iter(x.values())))
    w = np.ones(batch_size, dtype=np.float32)
    if n == batch_size:
        return x, y, w
    w[n:] = 0.0
    idx = np.arange(batch_size - n) % n

    def pad_arr(a):
        return np.concatenate([a, a[idx]], axis=0)

    x = {k: pad_arr(v) for k, v in x.items()}
    if y is not None:
        y = pad_arr(np.asarray(y))
    return x, y, w


class DeviceCachedLoader:
    """A dataset resident on the device: uploaded once, sliced per step there.

    The data is stacked as ``(n_groups, group_size, batch, ...)`` on
    ``device`` (the card unless the caller names another; with no card and
    no ``device`` it raises).  Rows that do not fill the last group are
    padded by cycling the real rows, with weight 0, as in :func:`pad_batch`.
    ``device_groups()`` yields ``(xs, ys, ws)`` groups, which the trainers
    consume without host staging; iterating yields host batches, as
    :class:`ArrayLoader` does, for evaluation and prediction.
    """

    def __init__(self, x: Dict[str, np.ndarray], y: Optional[np.ndarray] = None, batch_size: int = 256, group_size: int = 16, shuffle: bool = False, seed: int = 0, device=None):
        from ..trainers.base import resolve_device  # the trainers import this module

        self.device = resolve_device(device)
        self.x = {k: np.asarray(v) for k, v in x.items()}
        self.y = None if y is None else np.asarray(y)
        self.n = _check_lengths(self.x, self.y)
        self.batch_size = batch_size
        self.group_size = group_size
        self.shuffle = shuffle
        self.seed = seed

        chunk = batch_size * group_size
        n_groups = -(-self.n // chunk)
        padded = n_groups * chunk
        w = np.ones(padded, np.float32)
        w[self.n:] = 0.0
        idx = np.concatenate([np.arange(self.n), np.arange(padded - self.n) % max(self.n, 1)])
        self.n_groups = n_groups

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a).reshape(n_groups, group_size, batch_size, *a.shape[1:])).to(self.device)

        self._xs = {k: put(v[idx]) for k, v in self.x.items()}
        self._ys = None if self.y is None else put(self.y[idx].astype(np.float32))
        self._ws = put(w)
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self.n_groups * self.group_size

    @property
    def dataset_size(self) -> int:
        return self.n

    def first_batch(self):
        return ArrayLoader(self.x, self.y, self.batch_size).first_batch()

    def device_groups(self):
        """Yield ``(xs, ys, ws)`` groups of shape ``(group, batch, ...)`` on the device."""
        order = np.arange(self.n_groups)
        if self.shuffle:
            self._rng.shuffle(order)  # whole groups: the device data stays as uploaded
        for g in order:
            xs = {k: v[g] for k, v in self._xs.items()}
            yield xs, None if self._ys is None else self._ys[g], self._ws[g]

    def __iter__(self):
        """Host batches of the unpadded data, in order, as an unshuffled :class:`ArrayLoader` yields them."""
        return iter(ArrayLoader(self.x, self.y, self.batch_size))


class DataGenerator:
    """Train / validation / test split and the loaders over them."""

    def __init__(self, x: Dict[str, np.ndarray], y, seed: int = 42):
        self.x = {k: np.asarray(v) for k, v in x.items()}
        self.y = np.asarray(y)
        lengths = {k: len(v) for k, v in self.x.items()}
        if len(set(lengths.values()) | {len(self.y)}) != 1:
            raise ValueError(f"inconsistent lengths: labels={len(self.y)}, features={lengths}")
        self.length = len(self.y)
        self.seed = seed

    def generate_dataloader(self, x_val=None, y_val=None, x_test=None, y_test=None, split_ratio=None, batch_size: int = 16, num_workers: int = 0):
        """``(train, val, test)`` loaders; ``split_ratio=(train, val)`` splits this data at random from ``seed``."""
        if split_ratio is not None:
            train_length = int(self.length * split_ratio[0])
            val_length = int(self.length * split_ratio[1])
            test_length = self.length - train_length - val_length
            print(f"the samples of train : val : test are  {train_length} : {val_length} : {test_length}")
            order = np.random.default_rng(self.seed).permutation(self.length)
            tr, va, te = order[:train_length], order[train_length:train_length + val_length], order[train_length + val_length:]

            def take(idx):
                return {k: v[idx] for k, v in self.x.items()}, self.y[idx]

            (x_train, y_train), (x_val, y_val), (x_test, y_test) = take(tr), take(va), take(te)
        else:
            x_train, y_train = self.x, self.y
        train_loader = ArrayLoader(x_train, y_train, batch_size=batch_size, shuffle=True, seed=self.seed)
        val_loader = ArrayLoader(x_val, y_val, batch_size=batch_size) if x_val is not None else None
        test_loader = ArrayLoader(x_test, y_test, batch_size=batch_size) if x_test is not None else None
        return train_loader, val_loader, test_loader


class MatchDataGenerator:
    """The loaders of retrieval training: train ``(x, y)``, the test users and all items (``x`` only)."""

    def __init__(self, x: Dict[str, np.ndarray], y=None):
        self.x = {k: np.asarray(v) for k, v in x.items()}
        self.y = None if y is None else np.asarray(y)

    def generate_dataloader(self, x_test_user: Dict[str, np.ndarray], x_all_item: Dict[str, np.ndarray], batch_size: int = 16, num_workers: int = 0):
        train_loader = ArrayLoader(self.x, self.y, batch_size=batch_size, shuffle=True)
        test_loader = ArrayLoader(x_test_user, batch_size=batch_size)
        item_loader = ArrayLoader(x_all_item, batch_size=batch_size)
        return train_loader, test_loader, item_loader


def pad_sequences(sequences, maxlen=None, dtype="int32", padding="post", truncating="pre", value=0) -> np.ndarray:
    """Keras-style pad / truncate of ragged sequences to ``(n, maxlen)``."""
    lengths = [len(s) for s in sequences]
    if maxlen is None:
        maxlen = max(lengths) if lengths else 0
    out = np.full((len(sequences), maxlen), value, dtype=dtype)
    for i, seq in enumerate(sequences):
        seq = list(seq)
        if not seq:
            continue
        if truncating == "pre":
            trunc = seq[-maxlen:]
        elif truncating == "post":
            trunc = seq[:maxlen]
        else:
            raise ValueError(f"truncating must be pre/post, got {truncating!r}")
        if padding == "post":
            out[i, : len(trunc)] = trunc
        elif padding == "pre":
            out[i, -len(trunc):] = trunc
        else:
            raise ValueError(f"padding must be pre/post, got {padding!r}")
    return out


class SeqLoader:
    """Minibatch iterator over (seq_tokens, seq_positions, seq_time_diffs, target) tuples.

    numpy counterpart of the reference ``SeqDataset`` + DataLoader; yields
    4-tuples of numpy arrays in that order.  The trainer moves each batch to
    its device.
    """

    def __init__(self, seq_tokens, seq_positions, targets, seq_time_diffs, batch_size=32, shuffle=False, seed=0):
        self.seq_tokens = np.asarray(seq_tokens)
        self.seq_positions = np.asarray(seq_positions)
        self.targets = np.asarray(targets).reshape(-1)
        self.seq_time_diffs = np.asarray(seq_time_diffs)
        n = len(self.targets)
        if not (len(self.seq_tokens) == n and len(self.seq_positions) == n and len(self.seq_time_diffs) == n):
            raise ValueError(f"SeqLoader: {len(self.seq_tokens)} token rows, {len(self.seq_positions)} position rows, {len(self.seq_time_diffs)} time rows for {n} targets")
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        return (self.n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.arange(self.n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
            self._epoch += 1
        for start in range(0, self.n, self.batch_size):
            idx = order[start:start + self.batch_size]
            yield (self.seq_tokens[idx], self.seq_positions[idx], self.seq_time_diffs[idx], self.targets[idx])
