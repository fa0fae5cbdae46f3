"""The port's data helpers of ``utils/data.py`` against the JAX package's: the task defaults, the sequence
sample functions (which draw from an explicit ``random.Random`` where the JAX package draws from the global
``random``), ``array_replace_with_dict``, the session functions on the committed session samples, and ``load_embeddings``."""

import os
import random

import numpy as np
import pandas as pd
import pytest
import torch

from torch_rechub_tpu.utils import data as jdata
from torch_rechub_tpu_torch.utils import data as tdata

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks", "data")


def assert_frames_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert list(g.columns) == list(r.columns) and len(g) == len(r)
        pd.testing.assert_frame_equal(g, r)


def electronics():
    """The committed Amazon-Electronics rows (``user_id, item_id, time, cate_id``)."""
    return pd.read_csv(os.path.join(DATA, "amazon_electronics", "amazon_electronics_sample.csv"))


def diginetica():
    """The committed Diginetica click rows, as ``benchmarks/datasets.py:build_diginetica_session_dataset`` reads them."""
    raw = pd.read_csv(os.path.join(DATA, "diginetica", "train_item_views_sample.csv"), sep=";")
    return raw.rename(columns={"sessionId": "session_id", "itemId": "item_id", "eventdate": "time"})


def yidian():
    """The committed Yidian-News clicks as sessions: one per user and day, the show time as a timestamp."""
    raw = pd.read_csv(os.path.join(DATA, "yidian_news", "yidian_news_sample.csv"), index_col=0)
    clicks = raw[raw["click"] == 1]
    time = pd.to_datetime(clicks["showTime"], unit="ms")
    return pd.DataFrame({"session_id": clicks["userId"].astype(str) + "_" + time.dt.strftime("%m%d"), "item_id": clicks["itemId"], "time": time})


@pytest.mark.parametrize("fn", ["get_auto_embedding_dim", "get_loss_func", "get_metric_func"])
def test_task_defaults_match_jax(fn):
    args = [1, 7, 100, 10_000, 2**20] if fn == "get_auto_embedding_dim" else ["classification", "regression"]
    assert [getattr(tdata, fn)(a) for a in args] == [getattr(jdata, fn)(a) for a in args]
    if fn != "get_auto_embedding_dim":
        for mod in (tdata, jdata):
            with pytest.raises(ValueError, match="classification or regression"):
                getattr(mod, fn)("ranking")


def test_neg_sample_reads_the_same_stream():
    hist = [1, 2, 3, 5, 8]
    random.seed(4)
    ref = [jdata.neg_sample(hist, 9) for _ in range(50)]
    rng = random.Random(4)
    assert [tdata.neg_sample(hist, 9, rng) for _ in range(50)] == ref and not set(ref) & set(hist)


@pytest.mark.parametrize("shuffle", [True, False])
def test_generate_seq_feature_matches_jax(shuffle):
    """Sliding windows with negatives over the committed Amazon-Electronics rows, with the category as an item
    attribute; ``random.seed(s)`` before the JAX call, ``random.Random(s)`` to the port."""
    kw = dict(user_col="user_id", item_col="item_id", time_col="time", item_attribute_cols=["cate_id"], min_item=2, shuffle=shuffle, max_len=8)
    random.seed(11)
    ref = jdata.generate_seq_feature(electronics(), **kw)
    got = tdata.generate_seq_feature(electronics(), **kw, rng=random.Random(11))
    assert all(len(f) for f in ref)
    assert_frames_equal(got, ref)


def test_create_seq_features_matches_jax():
    random.seed(12)
    ref = jdata.create_seq_features(electronics(), max_len=6, drop_short=3)
    got = tdata.create_seq_features(electronics(), max_len=6, drop_short=3, rng=random.Random(12))
    assert all(len(f) for f in ref)
    assert_frames_equal(got, ref)


def test_array_replace_with_dict_matches_jax():
    rng = np.random.default_rng(0)
    keys = rng.permutation(np.arange(100, 160))
    dic = {int(k): int(v) for k, v in zip(keys, rng.integers(-5, 5, len(keys)))}
    array = rng.choice(keys, (7, 9))
    got = tdata.array_replace_with_dict(array, dic)
    np.testing.assert_array_equal(got, jdata.array_replace_with_dict(array, dic))
    assert got[2, 3] == dic[int(array[2, 3])]


@pytest.mark.parametrize("sample", ["diginetica", "yidian"])
def test_session_features_and_model_input_match_jax(sample):
    """``generate_session_features`` then ``session_model_input`` on the committed session samples."""
    frame, kw = (diginetica(), dict(min_item_freq=1, order_cols=("timeframe",))) if sample == "diginetica" else (yidian(), dict(min_item_freq=1, test_days=3))
    ref = jdata.generate_session_features(frame, **kw)
    got = tdata.generate_session_features(frame, **kw)
    assert got == ref and ref[0]
    # a news item is shown on one day only: every test-window click is of an item unseen in training, so the
    # yidian test split is dropped whole
    assert bool(ref[1]) == (sample == "diginetica")
    for sessions in ref[:2]:
        for max_seq_len in (19, 3):
            (gx, gy), (rx, ry) = tdata.session_model_input(sessions, max_seq_len), jdata.session_model_input(sessions, max_seq_len)
            np.testing.assert_array_equal(gx["hist_item_id"], rx["hist_item_id"])
            np.testing.assert_array_equal(gy, ry)
            assert gx["hist_item_id"].dtype == np.int32 and gy.dtype == np.int64


def test_load_embeddings_matches_jax(tmp_path):
    emb = np.random.default_rng(1).normal(size=(6, 4))
    np.save(tmp_path / "emb.npy", emb)
    torch.save(torch.from_numpy(emb), tmp_path / "emb.pt")
    for name in ("emb.npy", "emb.pt"):
        got = tdata.load_embeddings(str(tmp_path / name))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jdata.load_embeddings(str(tmp_path / name)))
    with pytest.raises(ValueError, match="Unsupported embedding format"):
        tdata.load_embeddings(str(tmp_path / "emb.txt"))
