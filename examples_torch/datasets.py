"""The example datasets of the PyTorch port: the bundles ``examples_torch/``'s scripts train on.

A copy of ``benchmarks/datasets.py``'s ``build_*_dataset`` functions and
their bundle dataclasses on the port's feature schema and preprocessing
(``torch_rechub_tpu_torch``).  Each builder reads the committed sample CSV
under ``benchmarks/data/<name>/`` when it is there (read only) and otherwise
draws a deterministic synthetic sample with the same columns; the arrays,
feature names, vocab sizes and embed dims are those of the JAX package's
builders.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Tuple

import numpy as np

from torch_rechub_tpu_torch.basic.features import DenseFeature, SequenceFeature, SparseFeature

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks", "data")


@dataclasses.dataclass
class RankingDatasetBundle:
    features: Tuple
    x_train: Dict
    y_train: np.ndarray
    x_test: Dict
    y_test: np.ndarray


@dataclasses.dataclass
class MatchingDatasetBundle:
    user_features: Tuple
    item_features: Tuple
    neg_item_feature: Tuple
    x_train: Dict
    y_train: np.ndarray
    x_test_user: Dict
    x_all_item: Dict
    test_user: Dict


@dataclasses.dataclass
class MultiTaskDatasetBundle:
    features: Tuple
    task_types: Tuple[str, ...]
    x_train: Dict
    y_train: np.ndarray
    x_test: Dict
    y_test: np.ndarray


def build_criteo_ranking_dataset(seed: int = 2022, n: int = 2000, embed_dim: int = 16):
    """Criteo-shaped: 26 sparse (C1..C26) + 13 dense (I1..I13), binary label."""
    csv = os.path.join(DATA_DIR, "criteo", "criteo_sample.csv")
    rng = np.random.default_rng(seed)
    if os.path.exists(csv):
        import pandas as pd

        df = pd.read_csv(csv)
        sparse_cols = [c for c in df.columns if c.startswith("C")]
        dense_cols = [c for c in df.columns if c.startswith("I")]
        for c in sparse_cols:
            df[c] = df[c].astype("category").cat.codes + 1
        for c in dense_cols:
            df[c] = np.log1p(df[c].fillna(0).clip(lower=0))
        y = df["label"].to_numpy(np.float32)
        x = {c: df[c].to_numpy(np.int32) for c in sparse_cols}
        x.update({c: df[c].to_numpy(np.float32) for c in dense_cols})
        vocab = {c: int(df[c].max()) + 1 for c in sparse_cols}
    else:
        sparse_cols = [f"C{i}" for i in range(1, 27)]
        dense_cols = [f"I{i}" for i in range(1, 14)]
        vocab = {c: 100 for c in sparse_cols}
        x = {c: rng.integers(0, 100, n).astype(np.int32) for c in sparse_cols}
        x.update({c: rng.normal(size=n).astype(np.float32) for c in dense_cols})
        logit = (x["C1"] % 2) * 1.0 + x["I1"] * 0.5 - 0.5
        y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    features = tuple(SparseFeature(c, vocab_size=vocab[c], embed_dim=embed_dim) for c in sparse_cols) + tuple(DenseFeature(c) for c in dense_cols)
    split = int(len(y) * 0.8)
    x_train = {k: v[:split] for k, v in x.items()}
    x_test = {k: v[split:] for k, v in x.items()}
    return RankingDatasetBundle(features, x_train, y[:split], x_test, y[split:])


def build_ml1m_matching_dataset(seed: int = 2022, n_users: int = 200, n_items: int = 300, n_inter: int = 4000, embed_dim: int = 16, seq_max_len: int = 20, mode: int = 2, neg_ratio: int = 3):
    """ML-1M two-tower retrieval bundle via the real preprocessing path.

    Loads the committed ``benchmarks/data/ml1m/ml1m_sample.csv`` (public
    MovieLens rows: user_id, movie_id, timestamp) when present; synthetic
    interactions otherwise.
    """
    import pandas as pd

    from torch_rechub_tpu_torch.utils.match import gen_model_input, generate_seq_feature_match

    rng = np.random.default_rng(seed)
    csv = os.path.join(DATA_DIR, "ml1m", "ml1m_sample.csv")
    if os.path.exists(csv):
        raw = pd.read_csv(csv)
        for col in ("user_id", "movie_id"):
            raw[col] = raw[col].astype("category").cat.codes + 1  # 0 = PAD
        df = pd.DataFrame({"user_id": raw["user_id"], "movie_id": raw["movie_id"], "time": raw["timestamp"]})
        n_users = int(df["user_id"].max()) + 1
        n_items = int(df["movie_id"].max()) + 1
    else:
        users = rng.integers(1, n_users, n_inter)
        items = ((users % 10) * (n_items // 10) + rng.integers(0, n_items // 10, n_inter)).clip(1, n_items - 1)
        df = pd.DataFrame({"user_id": users, "movie_id": items, "time": rng.integers(0, 10**6, n_inter)})
    df_train, df_test = generate_seq_feature_match(df, "user_id", "movie_id", "time", mode=mode, neg_ratio=neg_ratio, min_item=3)
    user_profile = pd.DataFrame({"user_id": np.arange(n_users)})
    item_profile = pd.DataFrame({"movie_id": np.arange(n_items)})
    x_train = gen_model_input(df_train, user_profile, "user_id", item_profile, "movie_id", seq_max_len=seq_max_len)
    x_test = gen_model_input(df_test, user_profile, "user_id", item_profile, "movie_id", seq_max_len=seq_max_len)
    if mode == 0:
        y_train = np.asarray(x_train.pop("label"), np.float32)
    else:
        x_train.pop("label", None)
        y_train = np.zeros(len(x_train["user_id"]), np.int64)
    x_test.pop("label", None)

    user_features = (
        SparseFeature("user_id", vocab_size=n_users, embed_dim=embed_dim),
        SequenceFeature("hist_movie_id", vocab_size=n_items, embed_dim=embed_dim, pooling="mean", shared_with="movie_id"),
    )
    item_features = (SparseFeature("movie_id", vocab_size=n_items, embed_dim=embed_dim),)
    neg_item_feature = (SequenceFeature("neg_items", vocab_size=n_items, embed_dim=embed_dim, pooling="concat", shared_with="movie_id"),)
    x_all_item = {"movie_id": np.arange(n_items)}
    return MatchingDatasetBundle(user_features, item_features, neg_item_feature, x_train, y_train, x_test, x_all_item, x_test)


# reference's census dense column list (benchmarks/datasets.py:186-193)
_CENSUS_DENSE_COLS = ("age", "wage per hour", "capital gains", "capital losses", "divdends from stocks", "num persons worked for employer", "weeks worked in year")


def build_census_multitask_dataset(seed: int = 2022, n: int = 2000, embed_dim: int = 8):
    """Census-income MTL bundle: income -> cvr_label, marital status -> ctr_label.

    Loads the committed ``benchmarks/data/census/census_income_sample.csv``
    when present; synthetic fallback otherwise.
    """
    csv = os.path.join(DATA_DIR, "census", "census_income_sample.csv")
    rng = np.random.default_rng(seed)
    if os.path.exists(csv):
        import pandas as pd

        df = pd.read_csv(csv).fillna(0)
        df = df.rename(columns={"income": "cvr_label", "marital status": "ctr_label"})
        non_label = [c for c in df.columns if c not in ("cvr_label", "ctr_label")]
        dense_cols = [c for c in _CENSUS_DENSE_COLS if c in non_label]
        sparse_cols = [c for c in non_label if c not in dense_cols]
        x = {c: df[c].to_numpy(np.int32) for c in sparse_cols}
        x.update({c: df[c].to_numpy(np.float32) for c in dense_cols})
        y = df[["cvr_label", "ctr_label"]].to_numpy(np.float32)
        vocab = {c: int(df[c].max()) + 1 for c in sparse_cols}
        n = len(df)
    else:
        sparse_cols = [f"cat_{i}" for i in range(8)]
        dense_cols = [f"num_{i}" for i in range(5)]
        vocab = {c: 40 for c in sparse_cols}
        x = {c: rng.integers(0, 40, n).astype(np.int32) for c in sparse_cols}
        x.update({c: rng.normal(size=n).astype(np.float32) for c in dense_cols})
        l1 = (x["cat_0"] % 3 == 0).astype(np.float32) * 1.5 + x["num_0"] * 0.5 - 0.5
        l2 = (x["cat_1"] % 2).astype(np.float32) * 1.2 + x["num_1"] * 0.3 - 0.6
        y = np.stack([
            (rng.random(n) < 1 / (1 + np.exp(-l1))).astype(np.float32),
            (rng.random(n) < 1 / (1 + np.exp(-l2))).astype(np.float32),
        ], axis=1)
    features = tuple(SparseFeature(c, vocab_size=vocab[c], embed_dim=embed_dim) for c in sparse_cols) + tuple(DenseFeature(c) for c in dense_cols)
    split = int(n * 0.8)
    return MultiTaskDatasetBundle(
        features,
        ("classification", "classification"),
        {k: v[:split] for k, v in x.items()},
        y[:split],
        {k: v[split:] for k, v in x.items()},
        y[split:],
    )


def build_avazu_ranking_dataset(seed: int = 2022, n: int = 2000, embed_dim: int = 16, dataset_path: str = None):
    """Avazu-shaped: columns ``f0..f23`` (first 3 numeric, rest categorical),
    binary ``label``.  Mirrors the reference preprocessing
    (``examples/ranking/run_avazu.py``): dense filled with 0 and min-max
    scaled, each dense column additionally discretized into a ``*_cat``
    sparse twin (``log(x)^2`` bucket above 2), sparse label-encoded.
    """
    csv = dataset_path or os.path.join(DATA_DIR, "avazu", "avazu_sample.csv")
    rng = np.random.default_rng(seed)
    if os.path.exists(csv):
        import pandas as pd

        df = pd.read_csv(csv)
        feat_cols = [c for c in df.columns if c.startswith("f")]
        dense_cols, sparse_cols = feat_cols[:3], list(feat_cols[3:])
        df[sparse_cols] = df[sparse_cols].fillna("-996")
        df[dense_cols] = df[dense_cols].apply(pd.to_numeric, errors="coerce").fillna(0)
        for c in dense_cols:
            v = df[c].to_numpy(np.float64)
            df[c + "_cat"] = np.where(v > 2, (np.log(np.maximum(v, 1e-12)) ** 2).astype(np.int64), v.astype(np.int64) - 2)
            sparse_cols.append(c + "_cat")
            lo, hi = v.min(), v.max()
            df[c] = (v - lo) / (hi - lo) if hi > lo else 0.0
        for c in sparse_cols:
            df[c] = df[c].astype("category").cat.codes
        y = df["label"].to_numpy(np.float32)
        x = {c: df[c].to_numpy(np.int32) for c in sparse_cols}
        x.update({c: df[c].to_numpy(np.float32) for c in dense_cols})
        vocab = {c: int(df[c].max()) + 1 for c in sparse_cols}
    else:
        dense_cols = [f"f{i}" for i in range(3)]
        sparse_cols = [f"f{i}" for i in range(3, 24)] + [f"f{i}_cat" for i in range(3)]
        vocab = {c: 50 for c in sparse_cols}
        x = {c: rng.integers(0, 50, n).astype(np.int32) for c in sparse_cols}
        x.update({c: rng.random(n).astype(np.float32) for c in dense_cols})
        logit = (x["f3"] % 2) * 1.2 + x["f0"] * 0.8 - 0.9
        y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    features = tuple(SparseFeature(c, vocab_size=vocab[c], embed_dim=embed_dim) for c in sparse_cols) + tuple(DenseFeature(c) for c in dense_cols)
    split = int(len(y) * 0.8)
    return RankingDatasetBundle(features, {k: v[:split] for k, v in x.items()}, y[:split], {k: v[split:] for k, v in x.items()}, y[split:])


_ALICCP_DENSE = ("D109_14", "D110_14", "D127_14", "D150_14", "D508", "D509", "D702", "D853")


def _aliccp_frame(seed: int, n: int, dataset_path: str = None):
    """Load an Ali-CCP sample CSV (columns: sparse ids + D* dense + click/purchase)
    or synthesize one with the same schema."""
    csv = dataset_path or os.path.join(DATA_DIR, "ali_ccp", "ali_ccp_sample.csv")
    rng = np.random.default_rng(seed)
    if os.path.exists(csv):
        import pandas as pd

        df = pd.read_csv(csv)
        dense_cols = [c for c in df.columns if c in _ALICCP_DENSE]
        sparse_cols = [c for c in df.columns if c not in dense_cols and c not in ("click", "purchase")]
        x = {c: df[c].to_numpy(np.int32) for c in sparse_cols}
        x.update({c: df[c].to_numpy(np.float32) for c in dense_cols})
        vocab = {c: int(df[c].max()) + 1 for c in sparse_cols}
        click = df["click"].to_numpy(np.float32)
        purchase = df["purchase"].to_numpy(np.float32)
    else:
        sparse_cols = [f"{101 + i}" for i in range(10)]
        dense_cols = list(_ALICCP_DENSE)
        vocab = {c: 60 for c in sparse_cols}
        x = {c: rng.integers(0, 60, n).astype(np.int32) for c in sparse_cols}
        x.update({c: rng.normal(size=n).astype(np.float32) for c in dense_cols})
        l_click = (x["101"] % 3 == 0) * 1.4 + x["D508"] * 0.5 - 0.6
        click = (rng.random(n) < 1 / (1 + np.exp(-l_click))).astype(np.float32)
        l_buy = (x["102"] % 2) * 1.1 + x["D509"] * 0.4 - 1.2
        purchase = (click * (rng.random(n) < 1 / (1 + np.exp(-l_buy)))).astype(np.float32)
    return sparse_cols, dense_cols, vocab, x, click, purchase


def build_aliccp_ctr_dataset(seed: int = 2022, n: int = 2000, embed_dim: int = 16, dataset_path: str = None):
    """Ali-CCP CTR ranking: label = click (reference ``run_ali_ccp_ctr_ranking.py``)."""
    sparse_cols, dense_cols, vocab, x, click, _ = _aliccp_frame(seed, n, dataset_path)
    features = tuple(SparseFeature(c, vocab_size=vocab[c], embed_dim=embed_dim) for c in sparse_cols) + tuple(DenseFeature(c) for c in dense_cols)
    split = int(len(click) * 0.8)
    return RankingDatasetBundle(features, {k: v[:split] for k, v in x.items()}, click[:split], {k: v[split:] for k, v in x.items()}, click[split:])


def build_aliccp_multitask_dataset(seed: int = 2022, n: int = 2000, embed_dim: int = 16, dataset_path: str = None):
    """Ali-CCP MTL: tasks (cvr=purchase, ctr=click) — reference ``run_ali_ccp_multi_task.py``."""
    sparse_cols, dense_cols, vocab, x, click, purchase = _aliccp_frame(seed, n, dataset_path)
    features = tuple(SparseFeature(c, vocab_size=vocab[c], embed_dim=embed_dim) for c in sparse_cols) + tuple(DenseFeature(c) for c in dense_cols)
    y = np.stack([purchase, click], axis=1)  # [cvr, ctr] — reference task order
    split = int(len(click) * 0.8)
    return MultiTaskDatasetBundle(features, ("classification", "classification"), {k: v[:split] for k, v in x.items()}, y[:split], {k: v[split:] for k, v in x.items()}, y[split:])


def build_aliexpress_multitask_dataset(seed: int = 2022, n: int = 2000, embed_dim: int = 5, dataset_path: str = None):
    """AliExpress-shaped MTL: ``categorical_*``/``numerical_*`` columns,
    tasks (conversion, click) — reference ``run_aliexpress.py``."""
    csv = dataset_path or os.path.join(DATA_DIR, "aliexpress", "aliexpress_sample.csv")
    rng = np.random.default_rng(seed)
    if os.path.exists(csv):
        import pandas as pd

        df = pd.read_csv(csv)
        sparse_cols = [c for c in df.columns if c.startswith("categorical")]
        dense_cols = [c for c in df.columns if c.startswith("numerical")]
        x = {c: df[c].to_numpy(np.int32) for c in sparse_cols}
        x.update({c: df[c].to_numpy(np.float32) for c in dense_cols})
        vocab = {c: int(df[c].max()) + 1 for c in sparse_cols}
        y = df[["conversion", "click"]].to_numpy(np.float32)
    else:
        sparse_cols = [f"categorical_{i}" for i in range(16)]
        dense_cols = [f"numerical_{i}" for i in range(8)]
        vocab = {c: 30 for c in sparse_cols}
        x = {c: rng.integers(0, 30, n).astype(np.int32) for c in sparse_cols}
        x.update({c: rng.normal(size=n).astype(np.float32) for c in dense_cols})
        l_click = (x["categorical_0"] % 2) * 1.3 + x["numerical_0"] * 0.5 - 0.5
        click = (rng.random(n) < 1 / (1 + np.exp(-l_click))).astype(np.float32)
        l_conv = (x["categorical_1"] % 3 == 0) * 1.2 + x["numerical_1"] * 0.4 - 1.0
        conversion = (click * (rng.random(n) < 1 / (1 + np.exp(-l_conv)))).astype(np.float32)
        y = np.stack([conversion, click], axis=1)
    features = tuple(SparseFeature(c, vocab_size=vocab[c], embed_dim=embed_dim) for c in sparse_cols) + tuple(DenseFeature(c) for c in dense_cols)
    split = int(len(y) * 0.8)
    return MultiTaskDatasetBundle(features, ("classification", "classification"), {k: v[:split] for k, v in x.items()}, y[:split], {k: v[split:] for k, v in x.items()}, y[split:])


@dataclasses.dataclass
class SessionDatasetBundle:
    item_history_feature: SequenceFeature
    n_items: int
    x_train: Dict
    y_train: np.ndarray
    x_test: Dict
    y_test: np.ndarray


def build_diginetica_session_dataset(seed: int = 2022, embed_dim: int = 32, max_seq_len: int = 19, min_item_freq: int = 1, test_days: int = 7, dataset_path: str = None):
    """Diginetica session-based bundle for NARM/STAMP (reference ``run_sbr.py``).

    Loads the committed ``benchmarks/data/diginetica/train_item_views_sample.csv``
    (public CIKM Cup 2016 click-stream rows) when present; synthetic Markov
    sessions otherwise.  ``min_item_freq`` defaults to 1 on the tiny sample
    (the reference uses 5 on the full dataset, which would leave 3 items here).
    """
    from torch_rechub_tpu_torch.utils.data import generate_session_features, session_model_input

    csv = dataset_path or os.path.join(DATA_DIR, "diginetica", "train_item_views_sample.csv")
    if os.path.exists(csv):
        import pandas as pd

        raw = pd.read_csv(csv, sep=";")
        df = raw.rename(columns={"sessionId": "session_id", "itemId": "item_id", "eventdate": "time"})
        train_sessions, test_sessions, n_items = generate_session_features(df, min_item_freq=min_item_freq, test_days=test_days, order_cols=("timeframe",))
    else:
        rng = np.random.default_rng(seed)
        n_items = 120
        trans = rng.integers(1, n_items, (n_items, 3))
        sessions = []
        for _ in range(300):
            cur, sess = int(rng.integers(1, n_items)), []
            for _ in range(int(rng.integers(3, 10))):
                sess.append(cur)
                cur = int(trans[cur, rng.integers(0, 3)])
            sessions.append(sess)
        train_sessions, test_sessions = sessions[:270], sessions[270:]
    x_train, y_train = session_model_input(train_sessions, max_seq_len)
    x_test, y_test = session_model_input(test_sessions, max_seq_len)
    fea = SequenceFeature("hist_item_id", vocab_size=n_items, embed_dim=embed_dim, pooling="concat", padding_idx=0)
    return SessionDatasetBundle(fea, n_items, x_train, y_train, x_test, y_test)


@dataclasses.dataclass
class SBCDatasetBundle:
    user_features: Tuple
    item_features: Tuple
    sample_weight_feature: Tuple
    x_train: Dict
    y_train: np.ndarray
    x_test_user: Dict
    x_all_item: Dict
    test_user: Dict


def build_yidian_sbc_dataset(seed: int = 2022, embed_dim: int = 16, seq_max_len: int = 10, dataset_path: str = None):
    """Yidian-News two-tower SBC bundle (reference ``examples/matching/README.md``
    YiDian-News section + ``run_ml_youtube_sbc.py`` recipe).

    Click events become the interaction stream; user profile carries the
    news-feed context columns (network/OS/province/city + dense age/gender
    probabilities); items carry a word2vec ``sample_weight`` DenseFeature for
    YoutubeSBC's in-batch log-bias correction.
    """
    import pandas as pd

    from torch_rechub_tpu_torch.utils.match import gen_model_input, generate_seq_feature_match, get_item_sample_weight

    csv = dataset_path or os.path.join(DATA_DIR, "yidian_news", "yidian_news_sample.csv")
    rng = np.random.default_rng(seed)
    user_sparse = ("network", "os", "province", "city")
    user_dense = ("age0", "age1", "age2", "age3", "female", "male")
    if os.path.exists(csv):
        raw = pd.read_csv(csv, index_col=0).rename(columns={"userId": "user_id", "itemId": "item_id", "showTime": "time", "OS": "os"})
        data = raw[raw["click"] == 1].reset_index(drop=True)
    else:
        n = 600
        data = pd.DataFrame({
            "user_id": rng.integers(0, 40, n),
            "item_id": rng.integers(0, 150, n),
            "time": rng.integers(0, 10**6, n),
            "network": rng.integers(0, 5, n),
            "os": np.array(["Android", "iPhone"])[rng.integers(0, 2, n)],
            "province": rng.integers(0, 10, n),
            "city": rng.integers(0, 30, n),
        })
        for c in user_dense:
            data[c] = rng.random(n).astype(np.float32)
    for col in ("user_id", "item_id") + user_sparse:
        data[col] = data[col].astype("category").cat.codes + 1
    n_users, n_items = int(data["user_id"].max()) + 1, int(data["item_id"].max()) + 1
    weight_map = get_item_sample_weight(data["item_id"].tolist())
    data["sample_weight"] = data["item_id"].map(weight_map).astype(np.float32)

    user_profile = data[["user_id", *user_sparse, *user_dense]].drop_duplicates("user_id")
    item_profile = data[["item_id", "sample_weight"]].drop_duplicates("item_id")
    # mode=0 / neg_ratio=0: SBC samples its negatives in-batch (reference
    # run_ml_youtube_sbc.py:47 comment), label col dropped below
    df_train, df_test = generate_seq_feature_match(data, "user_id", "item_id", time_col="time", sample_method=1, mode=0, neg_ratio=0, min_item=0)
    x_train = gen_model_input(df_train, user_profile, "user_id", item_profile, "item_id", seq_max_len=seq_max_len)
    x_train.pop("label", None)
    # list-wise CE target: the positive sits at column 0 of SBC's (B, 1+n_neg) logits
    y_train = np.zeros(len(x_train["user_id"]), np.int64)
    x_test = gen_model_input(df_test, user_profile, "user_id", item_profile, "item_id", seq_max_len=seq_max_len)
    x_test.pop("label", None)

    user_features = (
        SparseFeature("user_id", vocab_size=n_users, embed_dim=embed_dim),
        *(SparseFeature(c, vocab_size=int(data[c].max()) + 1, embed_dim=embed_dim) for c in user_sparse),
        *(DenseFeature(c) for c in user_dense),
        SequenceFeature("hist_item_id", vocab_size=n_items, embed_dim=embed_dim, pooling="mean", shared_with="item_id"),
    )
    item_features = (SparseFeature("item_id", vocab_size=n_items, embed_dim=embed_dim),)
    sample_weight_feature = (DenseFeature("sample_weight"),)
    all_weight = item_profile.set_index("item_id")["sample_weight"].reindex(np.arange(n_items), fill_value=float(data["sample_weight"].min())).to_numpy(np.float32)
    x_all_item = {"item_id": np.arange(n_items), "sample_weight": all_weight}
    return SBCDatasetBundle(user_features, item_features, sample_weight_feature, x_train, y_train, x_test, x_all_item, x_test)


DATASETS = {
    "criteo-sample": build_criteo_ranking_dataset,
    "ml-1m-sample": build_ml1m_matching_dataset,
    "census-income-sample": build_census_multitask_dataset,
    "avazu-sample": build_avazu_ranking_dataset,
    "ali-ccp-ctr-sample": build_aliccp_ctr_dataset,
    "ali-ccp-mtl-sample": build_aliccp_multitask_dataset,
    "aliexpress-sample": build_aliexpress_multitask_dataset,
    "diginetica-sample": build_diginetica_session_dataset,
    "yidian-news-sample": build_yidian_sbc_dataset,
}
