"""The port's retrieval serving against the JAX package: exact top-k
(``brute_force_topk``), the brute-force indexer under the ``ip``, ``l2`` and
``angular`` metrics with its ``.npy`` save and load, ``multi_interest_topk``,
``match_evaluation`` and the retrieval metrics (``topk_metrics``,
``diversity_score``, ``coverage_score``, ``novelty_score``), on the CPU;
``builder_factory``'s backends (the approximate ones in
``tests/test_torch_serving_ann.py``); and the port's
mirrors of ``tests/test_retrieval.py`` and the brute-force cases of
``tests/test_serving.py``.  Ids are compared exactly on data without ties,
scores at rtol 1e-5 / atol 1e-5 (a dot product of 8-16 fp32 terms, summed in
another order).
"""

import numpy as np
import pytest
import torch

from torch_rechub_tpu import serving as jserving
from torch_rechub_tpu.basic import metric as jmetric
from torch_rechub_tpu_torch import serving as tserving
from torch_rechub_tpu_torch.basic import metric as tmetric

RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def corpus(n=500, d=16, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("batch_size", [8192, 7])
def test_brute_force_topk_matches_jax(batch_size):
    users, items = corpus(33, 8, seed=1), corpus(300, 8, seed=2)
    ref_ids, ref_scores = jserving.brute_force_topk(users, items, k=6)
    ids, scores = tserving.brute_force_topk(users, items, k=6, batch_size=batch_size, device="cpu")
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_allclose(scores, ref_scores, rtol=RTOL, atol=ATOL)
    assert ids.dtype == np.int64 and scores.dtype == np.float32


@pytest.mark.parametrize("metric", ["ip", "dot", "l2", "angular"])
def test_bruteforce_indexer_matches_jax(tmp_path, metric):
    emb, q = corpus(), corpus(9, seed=3) * 2.0
    with jserving.builder_factory("bruteforce", metric=metric).from_embeddings(emb) as jindex:
        ref_ids, ref_dist = jindex.query(q, top_k=5)
        ref_one = jindex.query(q[0], top_k=3)
    builder = tserving.builder_factory("bruteforce", metric=metric, device="cpu")
    with builder.from_embeddings(emb) as index:
        ids, dist = index.query(q, top_k=5)
        one = index.query(q[0], top_k=3)  # a single 1-D query
        index.save(tmp_path / "bf")
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_allclose(dist, ref_dist, rtol=RTOL, atol=1e-4 if metric == "l2" else ATOL)
    np.testing.assert_array_equal(one[0], ref_one[0])
    with builder.from_index_file(tmp_path / "bf") as index:  # ".npy" is added, as numpy adds it on save
        np.testing.assert_array_equal(index.query(q, top_k=5)[0], ids)


def test_retrieval_ties_keep_their_scores():
    """Among equal scores ``torch.topk`` may return other ids than ``jax.lax.top_k`` (the lower index
    first): on a corpus of duplicated items the ids may differ, but each returned id's score and the
    score list are JAX's."""
    items = np.repeat(corpus(50, 8, seed=4), 3, axis=0)
    users = corpus(20, 8, seed=5)
    ref_ids, ref_scores = jserving.brute_force_topk(users, items, k=7)
    ids, scores = tserving.brute_force_topk(users, items, k=7, device="cpu")
    np.testing.assert_allclose(scores, ref_scores, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.take_along_axis(users @ items.T, ids, 1), ref_scores, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(ids // 3, ref_ids // 3)  # the same distinct items, in score order


def test_multi_interest_topk_matches_jax():
    users, items = corpus(12 * 4, 8, seed=6).reshape(12, 4, 8), corpus(80, 8, seed=7)
    users[0, 1] = users[0, 0] + 1e-3  # nearly the same interest: the same top items, deduplicated
    ref = jserving.multi_interest_topk(users, items, k=6)
    got = tserving.multi_interest_topk(users, items, k=6, device="cpu")
    np.testing.assert_array_equal(got, ref)
    assert all(len(set(row)) == 6 for row in got.tolist())


@pytest.mark.parametrize("multi", [False, True])
def test_match_evaluation_matches_jax(tmp_path, multi):
    """The whole protocol, without pandas in the port: repeated test users, raw id maps restored."""
    rng = np.random.default_rng(8)
    n_users, n_items = 30, 60
    item_emb = rng.normal(size=(n_items, 8)).astype(np.float32)
    test_user = {"user_id": rng.integers(0, 12, n_users), "item_id": rng.integers(0, n_items, n_users)}
    user_emb = rng.normal(size=(n_users, 3, 8) if multi else (n_users, 8)).astype(np.float32)
    user_emb[:5] = item_emb[test_user["item_id"][:5]][:, None] if multi else item_emb[test_user["item_id"][:5]]
    all_item = {"item_id": np.arange(n_items) + 100}
    maps = tmp_path / "maps.npy"
    user_map = {u: f"u{u}" for u in range(12)}
    item_map = {i + 100: f"i{i}" for i in range(n_items)}
    np.save(maps, np.array([user_map, item_map], dtype=object), allow_pickle=True)
    test_user = {"user_id": test_user["user_id"], "item_id": test_user["item_id"] + 100}
    for raw in (None, str(maps)):
        ref = jserving.match_evaluation(user_emb, item_emb, test_user, all_item, raw_id_maps=raw, topk=10)
        got = tserving.match_evaluation(user_emb, item_emb, test_user, all_item, raw_id_maps=raw, topk=10, device="cpu")
        assert dict(got) == dict(ref)
    with pytest.raises(ValueError, match="align"):
        tserving.match_evaluation(user_emb[:-1], item_emb, test_user, all_item, device="cpu")


def test_topk_metrics_match_jax():
    rng = np.random.default_rng(9)
    y_true = {u: list(rng.choice(40, rng.integers(1, 6), replace=False)) for u in range(25)}
    y_true[3] = []  # a user without ground truth counts in the averages and adds nothing
    y_pred = {u: list(rng.choice(40, 12, replace=False)) for u in range(25)}
    for ks in ([5], [1, 3, 10]):
        assert dict(tmetric.topk_metrics(y_true, y_pred, ks)) == dict(jmetric.topk_metrics(y_true, y_pred, ks))
    for fn in ("ndcg_score", "mrr_score", "recall_score", "hit_score", "precision_score"):
        assert getattr(tmetric, fn)(y_true, y_pred, [3]) == getattr(jmetric, fn)(y_true, y_pred, [3])
    with pytest.raises(ValueError):
        tmetric.topk_metrics(y_true, y_pred, 5)
    emb = rng.normal(size=(40, 6))
    emb_dict = {i: emb[i] for i in range(0, 40, 2)}
    pop = {i: float(p) for i, p in enumerate(rng.dirichlet(np.ones(40)))}
    for ks in ([5], [2, 10]):
        assert dict(tmetric.diversity_score(y_pred, emb, ks)) == dict(jmetric.diversity_score(y_pred, emb, ks))
        assert dict(tmetric.diversity_score(y_pred, emb_dict, ks)) == dict(jmetric.diversity_score(y_pred, emb_dict, ks))
        assert dict(tmetric.coverage_score(y_pred, list(range(40)), ks)) == dict(jmetric.coverage_score(y_pred, list(range(40)), ks))
        assert dict(tmetric.novelty_score(y_pred, pop, ks)) == dict(jmetric.novelty_score(y_pred, pop, ks))


def test_builder_factory_raises_for_the_backends_not_ported():
    """Every backend is ported: the factory returns each one's builder class, as the JAX package's does (the
    optional packages are imported at the first build, not here); an unknown name, a metric a backend does not
    take and anything but a mesh raise."""
    for name in ("annoy", "faiss", "milvus", "hnsw", "bruteforce"):
        builder, ref = tserving.builder_factory(name), jserving.builder_factory(name)
        assert type(builder).__name__ == type(ref).__name__ and type(builder).__module__ == f"torch_rechub_tpu_torch.serving.{name}"
        assert isinstance(builder, tserving.BaseBuilder)
    with pytest.raises(NotImplementedError):
        tserving.builder_factory("scann")
    with pytest.raises(ValueError):
        tserving.builder_factory("bruteforce", metric="cosine", device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):  # a mesh is taken (tests/test_torch_mesh_train.py); anything else raises
        tserving.brute_force_topk(corpus(2), corpus(3), 1, mesh=object(), device="cpu")


# ---------------------------------------------------------------------------
# the port's mirrors of tests/test_retrieval.py and tests/test_serving.py's brute-force cases
# ---------------------------------------------------------------------------

def test_mirror_brute_force_topk_exact():
    users, items = corpus(17, 8, seed=0), corpus(100, 8, seed=10)
    idx, vals = tserving.brute_force_topk(users, items, k=5, device="cpu")
    scores = users @ items.T
    expected = np.argsort(-scores, axis=1)[:, :5]
    np.testing.assert_array_equal(idx, expected)
    np.testing.assert_allclose(vals, np.take_along_axis(scores, expected, axis=1), rtol=1e-5)


def test_mirror_multi_interest_topk_dedups():
    users = np.zeros((1, 2, 4), dtype=np.float32)
    users[0, 0] = [1, 0, 0, 0]
    users[0, 1] = [1, 0.01, 0, 0]
    idx = tserving.multi_interest_topk(users, np.eye(4, dtype=np.float32), k=3, device="cpu")
    assert len(set(idx[0].tolist())) == 3


def test_mirror_match_evaluation_end_to_end():
    rng = np.random.default_rng(1)
    item_emb = rng.normal(size=(50, 8)).astype(np.float32)
    gt_items = rng.integers(0, 50, 20)
    out = tserving.match_evaluation(item_emb[gt_items], item_emb, {"user_id": np.arange(20), "item_id": gt_items}, {"item_id": np.arange(50)}, topk=10, device="cpu")
    assert float(out["Hit"][0].split(": ")[1]) == 1.0


def test_mirror_bruteforce_exact_and_save_load(tmp_path):
    emb = corpus()
    builder = tserving.builder_factory("bruteforce", metric="ip", device="cpu")
    q = emb[:5] + 0.01
    with builder.from_embeddings(emb) as indexer:
        ids, _ = indexer.query(q, top_k=3)
        np.testing.assert_array_equal(ids, np.argsort(-(q @ emb.T), axis=1)[:, :3])
        indexer.save(tmp_path / "bf.npy")
    with builder.from_index_file(tmp_path / "bf.npy") as indexer:
        np.testing.assert_array_equal(indexer.query(q, top_k=3)[0], ids)


def test_mirror_bruteforce_l2():
    emb = corpus()
    with tserving.builder_factory("bruteforce", metric="l2", device="cpu").from_embeddings(emb) as indexer:
        ids, d2 = indexer.query(emb[:3], top_k=1)
        np.testing.assert_array_equal(ids[:, 0], [0, 1, 2])
        np.testing.assert_allclose(d2[:, 0], 0.0, atol=1e-4)
