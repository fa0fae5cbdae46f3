"""The port's approximate retrieval backends against the JAX package's, on the CPU.

The native HNSW index (``serving/hnsw.py``) builds the same graph from the
same C++ source and flags, so its ids and distances equal the JAX package's
bit for bit, and the two packages read each other's index files.  annoy,
faiss and pymilvus are not installed: their wrappers run in both packages
against small fakes of the calls they make, installed in ``sys.modules``
for the test, so that each wrapper's own logic (the padding of short
results, the metric and the search knobs, the collection's lifecycle) is
compared without the packages.  The legacy engines of ``utils/match.py`` run
with the packages absent, where both packages substitute the native HNSW
(``Annoy``) and the exact brute-force index (``Faiss``).
"""

import os
import pickle
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_rechub_tpu import serving as jserving
from torch_rechub_tpu.utils import match as jmatch
from torch_rechub_tpu_torch import serving as tserving
from torch_rechub_tpu_torch.serving import hnsw as thnsw
from torch_rechub_tpu_torch.utils import match as tmatch

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-5  # the brute-force scores: a dot product of 16 fp32 terms, summed in another order


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def corpus(n=500, d=16, seed=0):
    """tests/test_serving.py's corpora."""
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def both(builder_kw, emb, queries, top_k):
    """``[(ids, distances)]`` of the JAX package's and the port's index built by ``builder_factory(**builder_kw)``."""
    out = []
    for serving in (jserving, tserving):
        with serving.builder_factory(**builder_kw).from_embeddings(emb) as indexer:
            out.append(indexer.query(queries, top_k))
    return out


# ---------------------------------------------------------------------------
# the native HNSW index
# ---------------------------------------------------------------------------

HNSW_CASES = {
    # tests/test_serving.py:test_native_hnsw_recall_and_save_load, and its l2 twin
    "ip": (dict(metric="ip", M=16, ef_construction=200, ef_search=128), lambda: (corpus(1000), corpus(50, seed=1)), 10),
    "l2": (dict(metric="l2", M=16, ef_construction=200, ef_search=128), lambda: (corpus(1000), corpus(50, seed=1)), 10),
    # tests/test_serving.py:test_native_hnsw_angular, with more neighbours
    "angular": (dict(metric="angular", ef_search=64), lambda: (corpus(300), corpus(300)[:4] * 5.0), 5),
}


@pytest.mark.parametrize("metric", HNSW_CASES)
def test_hnsw_matches_jax_bit_for_bit(metric):
    """The same seed, M, ef_construction and insertion order through the same source and flags: the same graph, so
    every query's ids and distances equal the JAX package's bit for bit."""
    kw, data, k = HNSW_CASES[metric]
    emb, q = data()
    (jids, jd), (ids, d) = both(dict(model="hnsw", **kw), emb, q, k)
    assert ids.dtype == jids.dtype == np.int64 and d.dtype == jd.dtype == np.float32
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(d, jd)


def test_hnsw_source_is_the_jax_package_s():
    """The port's copy of the C++ index is the JAX package's byte for byte: the bit-for-bit test's premise."""
    assert thnsw.SOURCE.read_bytes() == (ROOT / "torch_rechub_tpu" / "serving" / "native" / "hnsw.cpp").read_bytes()
    assert thnsw.GXX_FLAGS == ("-O3", "-shared", "-fPIC", "-std=c++17")


def test_index_files_move_between_the_packages(tmp_path):
    """An index saved by either package loads in the other and answers the same."""
    kw, data, k = HNSW_CASES["ip"]
    emb, q = data()
    for src, dst in ((jserving, tserving), (tserving, jserving)):
        path = str(tmp_path / f"{src.__name__}.hnsw")
        with src.builder_factory("hnsw", **kw).from_embeddings(emb) as indexer:
            want = indexer.query(q, k)
            indexer.save(path)
        with dst.builder_factory("hnsw", **kw).from_index_file(path) as indexer:
            assert indexer.size == len(emb)
            got = indexer.query(q, k)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(IOError):
        with tserving.builder_factory("hnsw").from_index_file(str(tmp_path / "missing.hnsw")):
            pass


@pytest.mark.parametrize("metric", ("ip", "l2"))
def test_hnsw_recall_and_size(metric):
    """tests/test_serving.py's recall@10 above 0.9 against the exact top 10, the index's size, and the distances
    ordered (similarities descending, squared distances ascending)."""
    kw, data, k = HNSW_CASES[metric]
    emb, q = data()
    exact = np.argsort(-(q @ emb.T) if metric == "ip" else ((q[:, None] - emb[None]) ** 2).sum(-1), axis=1)[:, :k]
    with tserving.builder_factory("hnsw", **kw).from_embeddings(emb) as indexer:
        assert indexer.size == len(emb)
        ids, d = indexer.query(q, k)
    recall = np.mean([len(set(ids[i]) & set(exact[i])) / k for i in range(len(q))])
    assert recall > 0.9, recall
    assert np.all(np.diff(d, axis=1) <= 1e-5) if metric == "ip" else np.all(np.diff(d, axis=1) >= -1e-5)


def test_hnsw_tensor_inputs_answer_as_arrays():
    """Items and queries given as tensors (a one-row query too) give the answers the arrays give."""
    kw, data, k = HNSW_CASES["ip"]
    emb, q = data()
    builder = tserving.builder_factory("hnsw", **kw)
    with builder.from_embeddings(emb) as a, builder.from_embeddings(torch.from_numpy(emb)) as t:
        for query in (q, q[0]):
            want, got = a.query(query, k), t.query(torch.from_numpy(query), k)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(ValueError, match="metric"):
        tserving.builder_factory("hnsw", metric="cosine")
    with builder.from_embeddings(emb) as a:  # the C index reads dim floats a query: a narrower one is refused
        with pytest.raises(ValueError, match="dimension 16"):
            a.query(q[:, :8], k)
    with pytest.raises(ValueError, match=r"\(n, d\)"):
        builder.from_embeddings(emb[0])


def test_hnsw_builds_into_the_ignored_build_directory():
    """The library lives in build/native/ at the root of the checkout, named by a hash of the source and flags, and
    nothing of the port's is written next to the JAX package's source."""
    path = thnsw.build()
    assert path.exists() and path.parent == ROOT / "build" / "native" and path.name.startswith("libhnsw-")
    assert thnsw.build() == path == thnsw.library_path()
    assert not list((ROOT / "torch_rechub_tpu_torch" / "serving" / "native").glob("*.so"))
    assert subprocess.run(["git", "check-ignore", "-q", str(path)], cwd=ROOT).returncode == 0


# ---------------------------------------------------------------------------
# annoy, faiss and milvus through fakes of the calls the wrappers make
# ---------------------------------------------------------------------------


class FakeAnnoyIndex:
    """``annoy.AnnoyIndex``'s calls: exact search; with ``search_k > 0`` at most ``search_k`` results, as annoy
    returns fewer items than asked when its search budget runs out."""

    def __init__(self, dim, metric):
        self.dim, self.metric, self.items, self.n_trees = dim, metric, {}, None

    def add_item(self, i, vector):
        assert isinstance(vector, list) and len(vector) == self.dim
        self.items[i] = np.asarray(vector, np.float32)

    def build(self, n_trees):
        self.n_trees = n_trees

    def get_nns_by_vector(self, vector, n, search_k=-1, include_distances=False):
        assert isinstance(vector, list) and include_distances
        x, v = np.stack([self.items[i] for i in sorted(self.items)]), np.asarray(vector, np.float32)
        d = {"dot": -(x @ v), "euclidean": np.sqrt(((x - v) ** 2).sum(1))}.get(self.metric, 1 - x @ v / np.linalg.norm(x, axis=1) / np.linalg.norm(v))
        order = np.argsort(d, kind="stable")[: n if search_k < 0 else min(n, search_k)]
        return order.tolist(), (np.abs(d[order]) if self.metric == "dot" else d[order]).tolist()

    def save(self, path):
        with open(path, "wb") as f:
            pickle.dump((self.metric, self.items), f)

    def load(self, path):
        with open(path, "rb") as f:
            self.metric, self.items = pickle.load(f)


class FakeFaissIndex:
    """A faiss index of ``index_factory``'s key: ``HNSW*`` has ``hnsw.efSearch``, ``IVF*`` ``nprobe`` and needs
    training; exact search under the metric, returning ``(distances, ids)``."""

    def __init__(self, d, key, metric):
        self.d, self.key, self.metric = d, key, metric
        self.is_trained, self.trained_on = not key.startswith("IVF"), None
        if key.startswith("HNSW"):
            self.hnsw = types.SimpleNamespace(efSearch=16)
        if key.startswith("IVF"):
            self.nprobe = 1
        self.x = np.zeros((0, d), np.float32)

    def train(self, x):
        self.trained_on, self.is_trained = x.shape, True

    def add(self, x):
        assert x.dtype == np.float32 and x.flags.c_contiguous and self.is_trained
        self.x = np.concatenate([self.x, x])

    def search(self, q, k):
        assert q.dtype == np.float32 and q.flags.c_contiguous
        score = q @ self.x.T if self.metric == 0 else -((q[:, None] - self.x[None]) ** 2).sum(-1)
        ids = np.argsort(-score, axis=1, kind="stable")[:, :k]
        d = np.take_along_axis(score, ids, 1)
        return (d if self.metric == 0 else -d).astype(np.float32), ids


def fake_faiss():
    m = types.ModuleType("faiss")
    m.METRIC_INNER_PRODUCT, m.METRIC_L2 = 0, 1
    m.index_factory = FakeFaissIndex

    def write_index(index, path):
        with open(path, "wb") as f:
            pickle.dump(index, f)

    def read_index(path):
        with open(path, "rb") as f:
            return pickle.load(f)

    m.write_index, m.read_index = write_index, read_index
    return m


def fake_pymilvus(server):
    """pymilvus's calls over ``server`` (``{collection name: collection}``); a search gives each query at most three
    hits, so a wrapper pads the rest."""
    m = types.ModuleType("pymilvus")
    m.DataType = types.SimpleNamespace(INT64="INT64", FLOAT_VECTOR="FLOAT_VECTOR")
    m.FieldSchema = lambda name, dtype, **kw: (name, dtype, kw)
    m.CollectionSchema = lambda fields: tuple(fields)
    log = server.setdefault("log", [])
    m.connections = types.SimpleNamespace(connect=lambda host, port: log.append(("connect", host, port)), disconnect=lambda alias: log.append(("disconnect", alias)))
    m.utility = types.SimpleNamespace(has_collection=lambda name: name in server, drop_collection=lambda name: log.append(("drop", name)) or server.pop(name))

    class Collection:
        def __new__(cls, name, schema=None):
            if schema is None:
                return server[name]
            c = super().__new__(cls)
            c.name, c.schema, c.index, c.loaded, c.flushed = name, schema, None, False, 0
            server[name] = c
            return c

        def insert(self, rows):
            self.ids, self.x = np.asarray(rows[0]), np.asarray(rows[1], np.float32)

        def create_index(self, field, params):
            assert field == "embedding"
            self.index = params

        def load(self):
            self.loaded = True

        def flush(self):
            self.flushed += 1

        def search(self, q, field, params, limit, output_fields):
            assert self.loaded and field == "embedding" and output_fields == ["id"]
            score = np.asarray(q, np.float32) @ self.x.T
            top = np.argsort(-score, axis=1, kind="stable")[:, : min(limit, 3)]
            return [[types.SimpleNamespace(id=int(self.ids[j]), distance=float(score[i, j])) for j in row] for i, row in enumerate(top)]

    m.Collection = Collection
    return m


@pytest.mark.parametrize("metric", ("angular", "euclidean", "dot"))
def test_annoy_wrapper_matches_jax_on_a_fake(monkeypatch, tmp_path, metric):
    """Both packages' annoy wrappers over the fake: the same ids and distances, a short result padded with id -1 at
    distance 0 (``search_k`` 3 of 5), the index file loaded back with ``dim``; tensors as arrays."""
    monkeypatch.setitem(sys.modules, "annoy", types.SimpleNamespace(AnnoyIndex=FakeAnnoyIndex))
    emb, q = corpus(60, 8), corpus(4, 8, seed=1)
    for search_k in (-1, 3):
        kw = dict(model="annoy", metric=metric, n_trees=7, search_k=search_k)
        (jids, jd), (ids, d) = both(kw, emb, q, 5)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(d, jd)
        if search_k == 3:
            assert (ids[:, 3:] == -1).all() and (d[:, 3:] == 0).all() and (ids[:, :3] >= 0).all()
    builder = tserving.builder_factory("annoy", metric=metric, dim=8)
    with builder.from_embeddings(torch.from_numpy(emb)) as indexer:
        assert indexer._index.n_trees == 10
        want = indexer.query(torch.from_numpy(q), 5)
        indexer.save(tmp_path / "a.ann")
    with builder.from_index_file(tmp_path / "a.ann") as indexer:
        got = indexer.query(q[0], 5)
    np.testing.assert_array_equal(got[0], want[0][:1])
    with pytest.raises(ValueError, match="dim"):
        tserving.builder_factory("annoy").from_index_file(tmp_path / "a.ann")
    with pytest.raises(ValueError):
        tserving.builder_factory("annoy", metric="cosine")


@pytest.mark.parametrize("metric", ("ip", "l2"))
@pytest.mark.parametrize("index_key,ef_search,nprobe", (("Flat", None, None), ("HNSW32", 48, None), ("IVF4,Flat", None, 3)))
def test_faiss_wrapper_matches_jax_on_a_fake(monkeypatch, tmp_path, metric, index_key, ef_search, nprobe):
    """Both packages' faiss wrappers over the fake: the metric passed to ``index_factory``, an untrained index trained
    on the items, ``efSearch`` / ``nprobe`` set where the index has them, the same ids and distances; an index file
    round trip; tensors as arrays."""
    monkeypatch.setitem(sys.modules, "faiss", fake_faiss())
    emb, q = corpus(80, 8), corpus(5, 8, seed=1)
    indexes = []
    for serving in (jserving, tserving):
        with serving.builder_factory("faiss", index_key=index_key, metric=metric, ef_search=ef_search, nprobe=nprobe).from_embeddings(emb) as indexer:
            indexes.append((indexer._index, indexer.query(q, 6)))
    (jindex, (jids, jd)), (index, (ids, d)) = indexes
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(d, jd)
    for ix in (jindex, index):
        assert ix.metric == (0 if metric == "ip" else 1) and ix.is_trained
        assert ix.trained_on == ((80, 8) if index_key.startswith("IVF") else None)
        assert getattr(getattr(ix, "hnsw", None), "efSearch", None) == ef_search
        assert getattr(ix, "nprobe", None) == (nprobe if index_key.startswith("IVF") else None)
    builder = tserving.builder_factory("faiss", index_key=index_key, metric=metric, ef_search=ef_search, nprobe=nprobe)
    with builder.from_embeddings(torch.from_numpy(emb)) as indexer:
        np.testing.assert_array_equal(indexer.query(torch.from_numpy(q), 6)[0], ids)
        indexer.save(tmp_path / "f.index")
    with builder.from_index_file(tmp_path / "f.index") as indexer:
        np.testing.assert_array_equal(indexer.query(q[0], 6)[0], ids[:1])
    with pytest.raises(ValueError):
        tserving.builder_factory("faiss", metric="angular")


def test_milvus_wrapper_matches_jax_on_a_fake(monkeypatch):
    """Both packages' Milvus wrappers over a fake server: the collection dropped and made again, the index's type
    and metric, the hits padded with id -1 at distance 0, the connection closed on exit, ``save`` a flush, and a
    collection loaded by name."""
    results, servers = [], []
    emb, q = corpus(40, 8), corpus(3, 8, seed=1)
    for serving in (jserving, tserving):
        server = {}
        monkeypatch.setitem(sys.modules, "pymilvus", fake_pymilvus(server))
        builder = serving.builder_factory("milvus", collection_name="items", index_type="HNSW", metric="ip", index_params={"M": 8}, search_params={"ef": 32})
        for _ in range(2):  # the second build drops the first collection
            with builder.from_embeddings(emb) as indexer:
                got = indexer.query(q, 5)
                indexer.save("unused")
        with builder.from_index_file("items") as indexer:
            again = indexer.query(q[0], 5)
        results.append((got, again))
        servers.append(server)
    (jgot, jagain), (got, again) = results
    for a, b in ((got, jgot), (again, jagain)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    assert (got[0][:, 3:] == -1).all() and (got[1][:, 3:] == 0).all()
    assert servers[0]["log"] == servers[1]["log"] and ("drop", "items") in servers[1]["log"] and servers[1]["log"][-1] == ("disconnect", "default")
    c = servers[1]["items"]
    assert c.index == {"index_type": "HNSW", "metric_type": "IP", "params": {"M": 8}} and c.flushed == 1  # the second collection, flushed once
    with pytest.raises(ValueError):
        tserving.builder_factory("milvus", index_type="IVF_PQ")


def test_milvus_contract_live():
    """The Milvus wrapper against a live server, gated on pymilvus as tests/test_serving.py gates it."""
    pytest.importorskip("pymilvus")
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(64, 8)).astype(np.float32)
    with tserving.builder_factory("milvus", collection_name="rechub_test", index_type="FLAT", metric="ip").from_embeddings(emb) as indexer:
        ids, dists = indexer.query(emb[:4], top_k=5)
        assert ids.shape == (4, 5) and dists.shape == (4, 5)


# ---------------------------------------------------------------------------
# the legacy engines of utils/match.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ("angular", "euclidean", "dot"))
def test_legacy_annoy_takes_the_native_hnsw_without_annoy(monkeypatch, metric):
    """Without annoy both packages' ``Annoy`` engines take the native HNSW under the matching metric: the same ids and
    distances bit for bit; a 1-D query answers with lists; ``fit`` again replaces the index."""
    monkeypatch.setitem(sys.modules, "annoy", None)
    emb, q = corpus(400), corpus(6, seed=1)
    engines = [m.Annoy(metric=metric, search_k=100) for m in (jmatch, tmatch)]
    assert isinstance(engines[1]._builder, thnsw.HnswBuilder) and engines[1]._builder.ef_search == 100
    (jids, jd), (ids, d) = [e.fit(emb).query(q, 10) for e in engines]
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(d, jd)
    one = [e.query(q[0], 10) for e in engines]
    assert one[1] == one[0] and isinstance(one[1][0], list)
    assert engines[1].fit(emb[:50]).query(torch.from_numpy(q), 3)[0].max() < 50


@pytest.mark.parametrize("metric", ("ip", "l2"))
def test_legacy_faiss_takes_brute_force_without_faiss(monkeypatch, metric):
    """Without faiss both packages' ``Faiss`` engines take the exact brute-force index: the same ids, distances within
    rtol 1e-5; the port's on ``device="cpu"``, and on the card by default (without one it raises)."""
    monkeypatch.setitem(sys.modules, "faiss", None)
    emb, q = corpus(300), corpus(7, seed=1)
    (jids, jd), (ids, d) = jmatch.Faiss(metric=metric).fit(emb).query(q, 8), tmatch.Faiss(metric=metric, device="cpu").fit(torch.from_numpy(emb)).query(q, 8)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(d, jd, rtol=RTOL, atol=ATOL)
    jone, one = jmatch.Faiss(metric=metric).fit(emb).query(q[0], 8), tmatch.Faiss(metric=metric, device="cpu").fit(emb).query(q[0], 8)
    assert one[0] == jone[0] and isinstance(one[0], list)
    np.testing.assert_allclose(one[1], jone[1], rtol=RTOL, atol=ATOL)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmatch.Faiss(metric=metric).fit(emb)


def test_legacy_engines_take_the_packages_where_present(monkeypatch):
    """With annoy and faiss present (the fakes) both packages' ``Annoy`` and ``Faiss`` engines take their wrappers and
    answer the same; ``Milvus`` takes the Milvus builder's settings."""
    monkeypatch.setitem(sys.modules, "annoy", types.SimpleNamespace(AnnoyIndex=FakeAnnoyIndex))
    monkeypatch.setitem(sys.modules, "faiss", fake_faiss())
    emb, q = corpus(50, 8), corpus(3, 8, seed=1)
    for make in (lambda m: m.Annoy(metric="dot", n_trees=3), lambda m: m.Faiss(index_key="HNSW8", metric="l2", ef_search=20)):
        (jids, jd), (ids, d) = [make(m).fit(emb).query(q, 4) for m in (jmatch, tmatch)]
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(d, jd)
    assert type(tmatch.Annoy()._builder).__name__ == "AnnoyBuilder" and type(tmatch.Faiss()._builder).__name__ == "FaissBuilder"
    jm, tm = jmatch.Milvus(collection_name="c", metric="l2"), tmatch.Milvus(collection_name="c", metric="l2")
    assert vars(tm._builder) == vars(jm._builder)
