"""Minibatch iterators and data helpers, as in ``torch_rechub_tpu/utils/data.py``.

Batches are dicts of numpy arrays (``ArrayLoader``, ``SeqLoader``), which
the trainers move to their device, or stacked tensors already on the card
(``DeviceCachedLoader``).  A trainer pads a partial batch to the loader's
``batch_size`` with ``pad_batch`` and weighs the padding rows 0.

The sequence and session sample functions (``neg_sample``, ``generate_seq_feature``,
``create_seq_features``, ``generate_session_features``,
``session_model_input``) are numpy / pandas code that feeds the sequence
models.  Where the JAX package draws from Python's global ``random``, the
port takes an explicit ``random.Random``: one seeded as the global stream
was gives the same frames.
"""

from __future__ import annotations

import math
import os
import random
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch


def df_to_dict(df) -> Dict[str, np.ndarray]:
    """A DataFrame as ``{column: np.ndarray}``."""
    return {col: df[col].to_numpy() for col in df.columns}


def get_auto_embedding_dim(num_classes: int) -> int:
    """``floor(6 * num_classes**0.25)``."""
    return int(math.floor(6 * num_classes**0.25))


def get_loss_func(task_type: str = "classification") -> str:
    """The default loss name of a task type."""
    if task_type == "classification":
        return "bce"
    if task_type == "regression":
        return "mse"
    raise ValueError("task_type must be classification or regression")


def get_metric_func(task_type: str = "classification") -> str:
    """The default metric name of a task type."""
    if task_type == "classification":
        return "auc"
    if task_type == "regression":
        return "mse"
    raise ValueError("task_type must be classification or regression")


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


class SequenceDataGenerator:
    """The loaders of HSTU / HLLM sequence data: one shuffled :class:`SeqLoader`, or a random ``(train, val, test)``
    split by ``split_ratio`` from ``seed`` (only the train loader shuffles)."""

    def __init__(self, seq_tokens, seq_positions, targets, seq_time_diffs, seed: int = 42):
        self.seq_tokens = np.asarray(seq_tokens)
        self.seq_positions = np.asarray(seq_positions)
        self.targets = np.asarray(targets).reshape(-1)
        self.seq_time_diffs = np.asarray(seq_time_diffs)
        self.seed = seed

    def generate_dataloader(self, batch_size=32, num_workers=0, split_ratio=None, shuffle=True):
        if split_ratio is None:
            return (SeqLoader(self.seq_tokens, self.seq_positions, self.targets, self.seq_time_diffs, batch_size=batch_size, shuffle=shuffle, seed=self.seed),)
        if abs(sum(split_ratio) - 1.0) >= 1e-6:
            raise ValueError("split_ratio must sum to 1.0")
        n = len(self.targets)
        order = np.random.default_rng(self.seed).permutation(n)
        n_train = int(n * split_ratio[0])
        n_val = int(n * split_ratio[1])
        parts = (order[:n_train], order[n_train:n_train + n_val], order[n_train + n_val:])
        return tuple(SeqLoader(self.seq_tokens[idx], self.seq_positions[idx], self.targets[idx], self.seq_time_diffs[idx], batch_size=batch_size, shuffle=(i == 0), seed=self.seed)
                     for i, idx in enumerate(parts))


def neg_sample(click_hist, item_size: int, rng: random.Random) -> int:
    """Rejection-sample one negative item id in ``[1, item_size]`` not in ``click_hist``."""
    neg = rng.randint(1, item_size)
    while neg in click_hist:
        neg = rng.randint(1, item_size)
    return neg


def _label_encode(data):
    """Every column label-encoded 1-based in sorted order (0 is PAD), as int32."""
    import pandas as pd

    data = data.copy()
    for feat in data:
        mapping = {v: i + 1 for i, v in enumerate(sorted(pd.unique(data[feat])))}
        data[feat] = data[feat].map(mapping)
    return data.astype("int32")


def generate_seq_feature(data, user_col, item_col, time_col, item_attribute_cols=None, min_item=0, shuffle=True, max_len=50, *, rng: random.Random):
    """Sliding-window sequence samples with 1:1 negatives for ranking.

    Every column is label-encoded 1-based (0 is PAD); per user, in time
    order, position ``i`` gives a positive row (the item at ``i``) and a
    negative row (a sampled item) over the zero-post-padded history before
    ``i``; the last position goes to test, the one before to validation.
    Returns ``(train, val, test)`` frames with the columns ``[label,
    target_item_id, <user_col>, hist_item_id, (hist_<attr>, target_<attr>)...]``.
    The negatives and the shuffles draw from ``rng``.
    """
    import pandas as pd

    item_attribute_cols = item_attribute_cols or []
    data = _label_encode(data)
    n_items = data[item_col].max()
    item2attr = {col: data[[item_col, col]].set_index(item_col)[col].to_dict() for col in item_attribute_cols}

    train_data, val_data, test_data = [], [], []
    data = data.sort_values(time_col)
    for uid, hist in data.groupby(user_col):
        pos_list = hist[item_col].tolist()
        if len(pos_list) < min_item:
            continue
        neg_list = [neg_sample(pos_list, n_items, rng) for _ in pos_list]
        for i in range(1, min(len(pos_list), max_len)):
            hist_item = pos_list[:i] + [0] * (max_len - i)
            pos_seq = [1, pos_list[i], uid, hist_item]
            neg_seq = [0, neg_list[i], uid, hist_item]
            for attr_col in item_attribute_cols:
                hist_attr = hist[attr_col].tolist()[:i] + [0] * (max_len - i)
                pos_seq += [hist_attr, item2attr[attr_col][pos_list[i]]]
                neg_seq += [hist_attr, item2attr[attr_col][neg_list[i]]]
            bucket = test_data if i == len(pos_list) - 1 else val_data if i == len(pos_list) - 2 else train_data
            bucket.append(pos_seq)
            bucket.append(neg_seq)

    col_name = ["label", "target_item_id", user_col, "hist_item_id"]
    for attr_col in item_attribute_cols:
        col_name += ["hist_" + attr_col, "target_" + attr_col]
    if shuffle:
        for bucket in (train_data, val_data, test_data):
            rng.shuffle(bucket)
    return tuple(pd.DataFrame(bucket, columns=col_name) for bucket in (train_data, val_data, test_data))


def array_replace_with_dict(array, dic):
    """Replace every value of ``array`` by ``dic[value]``, vectorised (every value must be a key)."""
    k = np.array(list(dic.keys()))
    v = np.array(list(dic.values()))
    idx = k.argsort()
    return v[idx[np.searchsorted(k, array, sorter=idx)]]


def create_seq_features(data, seq_feature_col=("item_id", "cate_id"), max_len=50, drop_short=3, shuffle=True, *, rng: random.Random):
    """DIN-style sequence samples from the columns ``user_id, item_id, cate_id, time``.

    Every column label-encoded 1-based; per user, the first ``max_len``
    clicks in time order (users with fewer than ``drop_short`` dropped);
    each click after the first gives a positive and a negative row over the
    zero-post-padded item and category histories; the last click goes to
    test, the one before to validation.  Returns ``(train, val, test)``
    frames with ``user_id, history_item, history_cate, target_item,
    target_cate, label``.  The negatives and the shuffles draw from ``rng``.
    """
    import pandas as pd

    data = _label_encode(data)
    n_items = data["item_id"].max()
    item2cate = data[["item_id", "cate_id"]].set_index("item_id")["cate_id"].to_dict()
    grouped = data.sort_values(["user_id", "time"]).groupby("user_id").agg(click=("item_id", list), cate=("cate_id", list)).reset_index()

    train_data, val_data, test_data = [], [], []
    for row in grouped.itertuples():
        clicks, cates = row.click[:max_len], row.cate[:max_len]
        if len(clicks) < drop_short:
            continue
        neg_list = [neg_sample(clicks, n_items, rng) for _ in clicks]
        hist, chist = [], []
        for i in range(1, len(clicks)):
            hist.append(clicks[i - 1])
            chist.append(cates[i - 1])
            hist_pad = hist + [0] * (max_len - len(hist))
            chist_pad = chist + [0] * (max_len - len(chist))
            pos = [row.user_id, hist_pad, chist_pad, clicks[i], cates[i], 1]
            neg = [row.user_id, hist_pad, chist_pad, neg_list[i], item2cate[neg_list[i]], 0]
            if i == len(clicks) - 1:
                test_data += [pos, neg]
            elif i == len(clicks) - 2:
                val_data += [pos, neg]
            else:
                train_data += [pos, neg]
    if shuffle:
        for bucket in (train_data, val_data, test_data):
            rng.shuffle(bucket)
    cols = ["user_id", "history_item", "history_cate", "target_item", "target_cate", "label"]
    return tuple(pd.DataFrame(bucket, columns=cols) for bucket in (train_data, val_data, test_data))


def generate_session_features(data, session_col="session_id", item_col="item_id", time_col="time", min_session_len=2, min_item_freq=5, test_days=7, time_format=None, order_cols=None):
    """Session-based preprocessing for NARM / STAMP-style recommenders.

    Drops sessions shorter than ``min_session_len`` and items seen fewer
    than ``min_item_freq`` times (then short sessions again), holds out the
    last ``test_days`` days as the test split, encodes items 1-based on the
    TRAIN rows only (0 is PAD; test events of unseen items are dropped, then
    short test sessions again), and groups each session into its
    time-ordered item list.  Returns ``(train_sessions, test_sessions,
    n_items)``, ``n_items`` the vocab size with PAD (max id + 1).
    """
    import pandas as pd

    df = data[[session_col, item_col, time_col] + list(order_cols or [])].copy()
    df[time_col] = pd.to_datetime(df[time_col], format=time_format)

    def _filter_session_len(frame, lo):
        sizes = frame.groupby(session_col)[item_col].transform("size")
        return frame[sizes >= lo]

    df = _filter_session_len(df, min_session_len)
    freq = df[item_col].map(df[item_col].value_counts())
    df = df[freq >= min_item_freq]
    df = _filter_session_len(df, min_session_len)

    cutoff = df[time_col].max() - pd.Timedelta(days=test_days)
    train_df, test_df = df[df[time_col] <= cutoff], df[df[time_col] > cutoff]

    encoding = {raw: i + 1 for i, raw in enumerate(sorted(train_df[item_col].unique()))}
    train_df = train_df.assign(**{item_col: train_df[item_col].map(encoding)})
    test_df = test_df.assign(**{item_col: test_df[item_col].map(encoding)}).dropna(subset=[item_col])
    test_df = _filter_session_len(test_df, min_session_len)

    def _sessions(frame):
        frame = frame.sort_values([session_col, time_col] + list(order_cols or []))
        return [list(map(int, items)) for items in frame.groupby(session_col)[item_col].agg(list)]

    n_items = int(train_df[item_col].max()) + 1 if len(train_df) else 1
    return _sessions(train_df), _sessions(test_df), n_items


def session_model_input(sessions, max_seq_len=19, hist_col="hist_item_id"):
    """Prefix-expand sessions into fixed-shape next-item arrays: ``[a, b, c]`` gives the histories ``[a]`` and
    ``[a, b]`` with the targets ``b`` and ``c``; a history keeps its FIRST ``max_seq_len`` items, zero-post-padded.
    Returns ``({hist_col: (N, max_seq_len) int32}, targets (N,) int64)``."""
    histories, targets = [], []
    for sess in sessions:
        for t in range(1, len(sess)):
            histories.append(sess[:t][:max_seq_len])
            targets.append(sess[t])
    x = pad_sequences(histories, maxlen=max_seq_len, padding="post", truncating="post")
    return {hist_col: np.asarray(x, np.int32)}, np.asarray(targets, np.int64)


def load_embeddings(data_path: str) -> np.ndarray:
    """Pre-computed embeddings as float32 numpy, from a ``.npy`` or a ``.pt`` (a saved tensor) file."""
    suffix = os.path.splitext(data_path)[-1]
    if suffix == ".npy":
        return np.asarray(np.load(data_path), dtype=np.float32)
    if suffix == ".pt":
        return torch.load(data_path, map_location="cpu", weights_only=True).cpu().numpy().astype(np.float32)
    raise ValueError(f"Unsupported embedding format: {suffix}")
