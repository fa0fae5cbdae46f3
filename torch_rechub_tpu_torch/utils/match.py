"""Matching and retrieval data utilities, and in-batch negative sampling.

Counterpart of ``torch_rechub_tpu/utils/match.py``: ``gen_model_input``
(profile merge and history padding), ``get_item_sample_weight``,
``negative_sample`` (four popularity methods), ``generate_seq_feature_match``
(mode 0 / 1 / 2 samples with a leave-one-out test split), all numpy and
pandas on the host and drawing from numpy's and ``random``'s global
generators as the JAX package does; and the in-batch pair
``inbatch_negative_sampling`` + ``gather_inbatch_logits`` on the device.

In-batch sampling is vectorised: uniform sampling without replacement is a
per-row top-k of random keys with the diagonal masked, hard negatives the
top-k of the scores with the diagonal masked.  Both take the top-k as
``jax.lax.top_k`` does, equal values in index order (:func:`stable_topk`):
a tied score matrix gives the JAX package's hard negatives.  The uniform
keys come from a ``torch.Generator``, so the draws differ from JAX's
(``keys=`` takes given keys instead).

Under a device mesh the global pool's scores are this rank's users against
every item of the global batch (``row_offset``: the row of this rank's first
user); the uniform keys are drawn at the global batch's shape and this
rank's rows taken, so the draws are ``mesh=None``'s.
``local_inbatch_loss`` is the per-shard pool: each data rank's own ``(b, b)``
block, combined exactly over the data group.

The legacy engines ``Annoy``, ``Faiss`` and ``Milvus`` give the serving
backends the ``fit(X)`` / ``query(v, n)`` interface of the examples, with the
JAX package's substitutions: ``Annoy`` takes the native HNSW index when the
annoy package is absent, ``Faiss`` the exact brute-force index when faiss is.
"""

from __future__ import annotations

import copy
import random
from collections import Counter, OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from ..parallel.distributed import global_mean
from .data import df_to_dict, pad_sequences


def gen_model_input(df, user_profile, user_col, item_profile, item_col, seq_max_len, padding="pre", truncating="pre"):
    """Merge the user and item profiles onto the samples and pad every ``hist_*`` / ``tag_*`` column."""
    import pandas as pd

    df = pd.merge(df, user_profile, on=user_col, how="left")
    df = pd.merge(df, item_profile, on=item_col, how="left")
    for col in df.columns.to_list():
        if col.startswith("hist_") or col.startswith("tag_"):
            df[col] = pad_sequences(df[col], maxlen=seq_max_len, value=0, padding=padding, truncating=truncating).tolist()
    input_dict = df_to_dict(df)
    for k, v in input_dict.items():
        if v.dtype == object:  # list-valued columns (hist_*, tag_*, neg_items, ...)
            try:
                input_dict[k] = np.stack([np.asarray(r) for r in v])
            except ValueError:
                pass  # a ragged column that is not a sequence stays as it is
    return input_dict


def get_item_sample_weight(items):
    """Word2vec-style sampling probabilities per item id: normalised ``count**0.75``
    (YoutubeSBC's log-bias correction, served as a ``DenseFeature('sample_weight')``)."""
    powered = {item: count**0.75 for item, count in Counter(items).items()}
    total = sum(powered.values())
    return {item: p / total for item, p in powered.items()}


def negative_sample(items_cnt_order, ratio, method_id: int = 0):
    """Global negatives by popularity from numpy's global generator.

    Methods: 0 uniform; 1 ``count**0.75`` (word2vec); 2 ``log(count+1)+1e-6``;
    3 Tencent RALM rank-based, without replacement.
    """
    items = list(items_cnt_order.keys())
    counts = np.array(list(items_cnt_order.values()), dtype=np.float64)
    if method_id == 0:
        return np.random.choice(items, size=ratio, replace=True)
    if method_id == 1:
        p = counts**0.75
    elif method_id == 2:
        p = np.log(counts + 1) + 1e-6
    elif method_id == 3:
        ranks = counts  # values are ranks for RALM
        p = (np.log(ranks + 2) - np.log(ranks + 1)) / np.log(len(items) + 1)
        return np.random.choice(items, size=ratio, replace=False, p=p / p.sum())
    else:
        raise ValueError("method id should in (0,1,2,3)")
    return np.random.choice(items, size=ratio, replace=True, p=p / p.sum())


def generate_seq_feature_match(data, user_col, item_col, time_col, item_attribute_cols=None, sample_method=0, mode=0, neg_ratio=0, min_item=0):
    """Sliding-window sequence samples and the leave-one-out test split, as two DataFrames.

    Mode 0 point-wise (the positive and ``neg_ratio`` labelled negatives),
    mode 1 pair-wise (one ``neg_items`` per sample), mode 2 list-wise
    (``neg_ratio`` negatives per sample).  The samples are shuffled by
    ``random``'s global generator.
    """
    import pandas as pd

    item_attribute_cols = item_attribute_cols or []
    if mode == 2:
        assert neg_ratio > 0, "neg_ratio must be greater than 0 when list-wise learning"
    elif mode == 1:
        neg_ratio = 1
    data = data.sort_values(time_col)
    items_cnt = Counter(data[item_col].tolist())
    items_cnt_order = OrderedDict(sorted(items_cnt.items(), key=lambda kv: kv[1], reverse=True))
    neg_list = negative_sample(items_cnt_order, ratio=data.shape[0] * max(neg_ratio, 1), method_id=sample_method)
    neg_idx = 0
    train_set, test_set = [], []
    n_cold_user = 0
    last_col = "label"
    for uid, hist in data.groupby(user_col):
        pos_list = hist[item_col].tolist()
        if len(pos_list) < min_item:
            n_cold_user += 1
            continue
        for i in range(1, len(pos_list)):
            sample = [uid, pos_list[i], pos_list[:i], i]
            for attr_col in item_attribute_cols:
                sample.append(hist[attr_col].tolist()[:i])
            if i != len(pos_list) - 1:
                if mode == 0:
                    last_col = "label"
                    train_set.append(sample + [1])
                    for _ in range(neg_ratio):
                        neg_sample = copy.deepcopy(sample)
                        neg_sample[1] = neg_list[neg_idx]
                        neg_idx += 1
                        train_set.append(neg_sample + [0])
                elif mode == 1:
                    last_col = "neg_items"
                    for _ in range(neg_ratio):
                        train_set.append(copy.deepcopy(sample) + [neg_list[neg_idx]])
                        neg_idx += 1
                elif mode == 2:
                    last_col = "neg_items"
                    train_set.append(sample + [list(neg_list[neg_idx:neg_idx + neg_ratio])])
                    neg_idx += neg_ratio
                else:
                    raise ValueError("mode should in (0,1,2)")
            else:
                test_set.append(sample + [1])
    random.shuffle(train_set)
    random.shuffle(test_set)
    print(f"n_train: {len(train_set)}, n_test: {len(test_set)}")
    print(f"{n_cold_user} cold start user dropped")
    attr_hist_cols = ["hist_" + c for c in item_attribute_cols]
    cols = [user_col, item_col, "hist_" + item_col, "histlen_" + item_col] + attr_hist_cols + [last_col]
    return pd.DataFrame(train_set, columns=cols), pd.DataFrame(test_set, columns=cols)


# ---------------------------------------------------------------------------
# in-batch negative sampling, on the device
# ---------------------------------------------------------------------------


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the ``k`` largest entries of each row, equal values in index order, as
    ``jax.lax.top_k`` gives them: a stable descending sort of the row, its first ``k`` columns."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def inbatch_negative_sampling(scores: torch.Tensor, neg_ratio: Optional[int] = None, hard_negative: bool = False, generator: Optional[torch.Generator] = None, keys: Optional[torch.Tensor] = None, row_offset: int = 0) -> torch.Tensor:
    """``(b, neg_ratio)`` int64 negative columns per row of a ``(b, B)`` score matrix, never the row's own.

    Row ``i`` is the batch's row ``row_offset + i`` and its own column is that
    one (a square matrix at offset 0 masks the diagonal).  ``neg_ratio`` is
    clamped to ``B − 1`` (``None`` or ``<= 0`` take all ``B − 1``).  Hard
    mode: the top scores with the own column masked.  Uniform mode:
    ``neg_ratio`` distinct columns, the top-k of U[0, 1) keys with the own
    column masked: the given ``keys (b, B)``, else ``(B, B)`` keys drawn from
    ``generator`` and these rows taken.  Neither takes a gradient.
    """
    if scores.ndim != 2:
        raise ValueError(f"inbatch_negative_sampling expects 2D scores, got shape {tuple(scores.shape)}")
    rows, batch_size = scores.shape
    if batch_size <= 1:
        raise ValueError("In-batch negative sampling requires batch_size > 1")
    max_neg = batch_size - 1
    if neg_ratio is None or neg_ratio <= 0 or neg_ratio > max_neg:
        neg_ratio = max_neg
    own = torch.arange(batch_size, device=scores.device)[None, :] == (row_offset + torch.arange(rows, device=scores.device))[:, None]
    if hard_negative:
        ranked = scores.detach()
    else:
        ranked = keys if keys is not None else torch.rand((batch_size, batch_size), generator=generator, device=scores.device)[row_offset: row_offset + rows]
    return stable_topk(ranked.masked_fill(own, -float("inf")), neg_ratio)[1]


def gather_inbatch_logits(scores: torch.Tensor, neg_indices: torch.Tensor, row_offset: int = 0) -> torch.Tensor:
    """``(b, 1 + K)`` logits: each row's own column (the diagonal at ``row_offset``), then the gathered negatives."""
    return torch.cat([torch.diagonal(scores, offset=row_offset)[:, None], torch.gather(scores, 1, neg_indices)], dim=1)


def inbatch_loss_from_logits(logits: torch.Tensor, mode: int, weight: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(Σ w·ℓ, Σ w)`` of the ``(B, 1 + K)`` in-batch logits: mode 1 BPR of the positive against every
    negative, else the list-wise CE with the positive in column 0.  The two sums, not the mean, so that
    shards combine exactly."""
    logits = logits.to(torch.float32)
    if mode == 1:
        per_sample = -torch.nn.functional.logsigmoid(logits[:, :1] - logits[:, 1:]).mean(1)
    else:
        per_sample = -torch.log_softmax(logits, dim=-1)[:, 0]
    w = torch.ones_like(per_sample) if weight is None else weight.to(per_sample.dtype).reshape(per_sample.shape)
    return (per_sample * w).sum(), w.sum()


def local_inbatch_loss(user_emb: torch.Tensor, item_emb: torch.Tensor, weight: Optional[torch.Tensor], rng: Optional[torch.Generator], mesh, mode: int, neg_ratio: Optional[int] = None, hard_negative: bool = False, data_axis: str = "data", keys: Optional[torch.Tensor] = None) -> torch.Tensor:
    """In-batch loss with a PER-SHARD negative pool (the reference's per-process semantics).

    Each rank passes its own rows: ``user_emb``, ``item_emb`` ``(b, D)``, the
    weights ``(b,)``.  It scores its ``(b, b)`` block, samples negatives from
    its own generator ``rng`` (or the given ``keys (b, b)``), and the data
    group's loss sums and weight sums combine exactly:
    ``Σ loss_sum / max(Σ w_sum, 1e-12)``, the global value on every rank with
    this rank's share of the gradient (``parallel.distributed.global_mean``).
    ``mesh=None`` takes the whole batch as one block.
    """
    scores = user_emb @ item_emb.T
    neg_idx = inbatch_negative_sampling(scores, neg_ratio=neg_ratio, hard_negative=hard_negative, generator=rng, keys=keys)
    loss_sum, w_sum = inbatch_loss_from_logits(gather_inbatch_logits(scores, neg_idx), mode, weight=weight)
    if mesh is None:
        return loss_sum / torch.clamp_min(w_sum, 1e-12)
    return global_mean(loss_sum, w_sum, mesh.group(data_axis), 1e-12)


# ---------------------------------------------------------------------------
# the legacy fit / query engines over the serving backends
# ---------------------------------------------------------------------------


class _LegacyEngine:
    """``fit(X)`` / ``query(v, n)`` over a serving ``BaseBuilder``: ``fit`` builds an index over the rows of ``X``
    (closing the one before), ``query`` returns ``(ids, distances)``, as lists for one 1-D query."""

    def __init__(self, builder):
        self._builder = builder
        self._indexer = None
        self._cm = None

    def fit(self, X):
        if self._cm is not None:
            self._cm.__exit__(None, None, None)
        self._cm = self._builder.from_embeddings(X)
        self._indexer = self._cm.__enter__()
        return self

    def query(self, v, n):
        ids, dists = self._indexer.query(v, n)
        if ids.shape[0] == 1 and np.ndim(v) == 1:
            return ids[0].tolist(), dists[0].tolist()
        return ids, dists


class Annoy(_LegacyEngine):
    """The annoy engine; without the annoy package, the native HNSW index (``serving/hnsw.py``) under the
    matching metric, as in the JAX package."""

    def __init__(self, metric="angular", n_trees=10, search_k=-1):
        try:
            import annoy  # noqa: F401

            from ..serving.annoy import AnnoyBuilder

            super().__init__(AnnoyBuilder(metric=metric, n_trees=n_trees, search_k=search_k))
        except ImportError:
            from ..serving.hnsw import HnswBuilder

            hnsw_metric = {"angular": "angular", "euclidean": "l2", "dot": "ip"}.get(metric, "angular")
            super().__init__(HnswBuilder(metric=hnsw_metric, ef_search=max(64, search_k)))


class Faiss(_LegacyEngine):
    """The faiss engine; without the faiss package, the exact brute-force index (``serving/bruteforce.py``) on
    ``device`` (the card unless the caller names another; with neither it raises), as in the JAX package."""

    def __init__(self, index_key="Flat", metric="ip", device=None, **kwargs):
        try:
            import faiss  # noqa: F401

            from ..serving.faiss import FaissBuilder

            super().__init__(FaissBuilder(index_key=index_key, metric=metric, **kwargs))
        except ImportError:
            from ..serving.bruteforce import BruteForceBuilder

            super().__init__(BruteForceBuilder(metric=metric, device=device))


class Milvus(_LegacyEngine):
    """The Milvus engine (``serving/milvus.py``; a live server)."""

    def __init__(self, **kwargs):
        from ..serving.milvus import MilvusBuilder

        super().__init__(MilvusBuilder(**kwargs))
