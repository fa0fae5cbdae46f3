"""The port's feature schema, initializer specs and ``EmbeddingCollection``
against the JAX package, on carried tables, for the three layouts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_rechub_tpu.basic import features as jfeat
from torch_rechub_tpu.basic import initializers as jinit
from torch_rechub_tpu.ops import embedding as jemb
from torch_rechub_tpu_torch.basic import features as tfeat
from torch_rechub_tpu_torch.basic import initializers as tinit
from torch_rechub_tpu_torch.ops import embedding as temb
from torch_rechub_tpu_torch.utils.jax_weights import load_flax_params

B, L, VOCAB, DIM, BIG, MID = 6, 5, 64, 8, 262144, 70_000
# pooling sums up to L products in another order than XLA's einsum
POOL_RTOL = 1e-6
# bench.py:51, the Criteo-full geometry
VOCABS_FULL = [4_000_000, 2_000_000, 1_000_000, 500_000, 300_000, 300_000, 200_000, 100_000, 50_000, 50_000] + [10_000] * 16


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def schema(mod):
    """Every kind of feature: padding_idx, shared_with, the three poolings, -1 padding, a table
    large enough to fuse under "auto", dense scalars and a dense vector."""
    kw = {"initializer": mod.initializers.RandomNormal(0.0, 1.0)}
    return {
        "a": mod.SparseFeature("a", VOCAB, DIM, **kw),
        "b": mod.SparseFeature("b", VOCAB, DIM, padding_idx=3, **kw),
        "b2": mod.SparseFeature("b2", VOCAB, DIM, shared_with="b", padding_idx=3),
        "s": mod.SequenceFeature("s", VOCAB, DIM, pooling="mean", **kw),  # padded with -1
        "t": mod.SequenceFeature("t", VOCAB, DIM, pooling="sum", padding_idx=0, **kw),
        "u": mod.SequenceFeature("u", VOCAB, DIM, pooling="concat", shared_with="s"),
        "big": mod.SparseFeature("big", BIG, DIM, **kw),
        "mid": mod.SparseFeature("mid", MID, DIM, **kw),  # per feature: padded to 64-row multiple
        "w": mod.SequenceFeature("w", VOCAB, DIM, pooling="sum", shared_with="big"),  # -1 in a fused table's first segment
        "d1": mod.DenseFeature("d1"),
        "d2": mod.DenseFeature("d2", embed_dim=3),
    }


class _JaxSchema:
    SparseFeature, SequenceFeature, DenseFeature = jfeat.SparseFeature, jfeat.SequenceFeature, jfeat.DenseFeature
    initializers = jinit


class _TorchSchema:
    SparseFeature, SequenceFeature, DenseFeature = tfeat.SparseFeature, tfeat.SequenceFeature, tfeat.DenseFeature
    initializers = tinit


def batch(seed=0):
    rng = np.random.default_rng(seed)
    x = {
        "a": rng.integers(0, VOCAB, B), "b": rng.integers(0, VOCAB, B), "b2": rng.integers(0, VOCAB, B),
        "s": rng.integers(0, VOCAB, (B, L)), "t": rng.integers(0, VOCAB, (B, L)), "u": rng.integers(0, VOCAB, (B, L)),
        "big": rng.integers(0, BIG, B), "mid": rng.integers(0, MID, B), "w": rng.integers(0, VOCAB, (B, L)),
    }
    x["b"][:2] = 3
    x["b2"][1:3] = 3
    for k in ("s", "u", "w"):  # -1 padding; row 0 all padding
        x[k][:, 3:] = -1
        x[k][0] = -1
    x["t"][:, 4:] = 0
    x["big"][0] = BIG - 1
    x = {k: v.astype(np.int32) for k, v in x.items()}
    x["d1"] = rng.normal(size=B).astype(np.float32)
    x["d2"] = rng.normal(size=(B, 3)).astype(np.float32)
    return x


# (features, squeeze_dim); features whose output is a gather and a mask only compare bit for bit
QUERIES = {
    "stacked": (["a", "b", "b2", "s", "t", "big", "mid", "w"], False),
    "squeezed with dense": (["d1", "a", "s", "big", "d2", "w"], True),
    "concat": (["u"], False),
    "concat squeezed": (["u", "d1"], True),
    "dense only": (["d1", "d2"], True),
}
GATHERED = ("a", "b", "b2", "big", "mid", "u")


def carried(fused):
    js, ts = schema(_JaxSchema), schema(_TorchSchema)
    x = batch()
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    jec = jemb.EmbeddingCollection(features=tuple(js.values()), fused=fused)
    params = jax.device_get(jec.init(jax.random.PRNGKey(0), jx, tuple(js[k] for k in QUERIES["stacked"][0]))["params"])
    tec = temb.EmbeddingCollection(tuple(ts.values()), fused=fused, generator=torch.Generator().manual_seed(0))
    load_flax_params(tec, params)
    return jec, params, tec, js, ts, x


@pytest.mark.parametrize("fused", [True, False, "auto"], ids=["fused", "per_feature", "auto"])
def test_embedding_collection_matches_jax(fused):
    jec, params, tec, js, ts, x = carried(fused)
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    for name, (keys, squeeze) in QUERIES.items():
        ref = np.asarray(jec.apply({"params": params}, jx, tuple(js[k] for k in keys), squeeze_dim=squeeze))
        got = tec(tx, tuple(ts[k] for k in keys), squeeze_dim=squeeze).detach().numpy()
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(got, ref, rtol=POOL_RTOL, atol=0, err_msg=name)
        if not squeeze:
            exact = [i for i, k in enumerate(keys) if k in GATHERED]
            np.testing.assert_array_equal(got[:, exact], ref[:, exact], err_msg=name)
    # a lookup of -1 reads what jnp.take reads: the gathered table's last row, or in a
    # fused table the previous owner's last row (the spare zero row for the first owner)
    u = tec(tx, (ts["u"],))[0, 0, 0].detach()
    if fused is True:
        np.testing.assert_array_equal(u.numpy(), tec.table("b")[-1].detach().numpy())  # "s" is fused after "b"
    else:
        np.testing.assert_array_equal(u.numpy(), tec.table("s")[-1].detach().numpy())


@pytest.mark.parametrize("fused", [True, False, "auto"], ids=["fused", "per_feature", "auto"])
def test_table_names_shapes_and_padding_match_jax(fused):
    jec, params, tec, js, ts, x = carried(fused)
    assert {k: tuple(v.shape) for k, v in tec.state_dict().items()} == {k: tuple(np.shape(v)) for k, v in params.items()}
    assert tec.layout.shapes() == {k: tuple(np.shape(v)) for k, v in params.items()}
    for owner in ("a", "b", "s", "t", "big", "mid"):
        np.testing.assert_array_equal(tec.table(owner).detach().numpy(), np.asarray(jec.apply({"params": params}, owner, method=jemb.EmbeddingCollection.table)))
    # the port's own init: the padding row and the padded rows are zero
    fresh = temb.EmbeddingCollection(tuple(ts.values()), fused=fused, generator=torch.Generator().manual_seed(1))
    assert not fresh.table("b")[3].any() and fresh.table("a").abs().sum() > 0
    for owner in fresh.layout.per_feature:
        assert not getattr(fresh, f"{owner}_table")[ts[owner].vocab_size:].any(), owner
    for dim, (rows, owners) in fresh.layout.fused.items():
        assert not getattr(fresh, f"fused_d{dim}_table")[sum(ts[o].vocab_size for o in owners):].any()
    if fused == "auto":
        assert set(tec.layout.fused) == {DIM} and tec.layout.fused[DIM][1] == ("big",)
        assert tec.layout.fused[DIM][0] == BIG + 64  # (ΣV // 64 + 1) * 64: a spare row, not a round-up
        assert tec.layout.per_feature["mid"] == 70_016


def test_criteo_full_layout_from_the_schema_alone():
    """bench.py's Criteo-full geometry under "auto", against jax.eval_shape of the JAX init:
    no table of either package is allocated."""
    jsparse = tuple(jfeat.SparseFeature(f"C{i}", v, 16) for i, v in enumerate(VOCABS_FULL))
    tsparse = tuple(tfeat.SparseFeature(f"C{i}", v, 16) for i, v in enumerate(VOCABS_FULL))
    jx = {f"C{i}": jax.ShapeDtypeStruct((4,), jnp.int32) for i in range(len(VOCABS_FULL))}
    shapes = jax.eval_shape(lambda x: jemb.EmbeddingCollection(features=jsparse, fused="auto").init(jax.random.PRNGKey(0), x, jsparse), jx)["params"]
    ref = {k: tuple(v.shape) for k, v in shapes.items()}
    got = temb.table_layout(tsparse, "auto").shapes()
    assert got == ref
    assert got["fused_d16_table"] == (8_100_032, 16)
    assert got["C6_table"] == (200_000, 16) and got["C7_table"] == (100_032, 16)
    assert sorted(got[f"C{i}_table"][0] for i in range(8, 26)) == [10_000] * 16 + [50_000] * 2
    assert len(got) == 21


def test_fused_default_and_layout_errors():
    old = temb.set_fused_default(False)
    try:
        assert old == "auto"
        assert temb.table_layout((tfeat.SparseFeature("z", BIG, 4),)).fused == {}
        with pytest.raises(ValueError, match="fused default"):
            temb.set_fused_default("yes")
    finally:
        temb.set_fused_default(old)
    with pytest.raises(ValueError, match="fused must be"):
        temb.table_layout((), fused="no")
    ec = temb.EmbeddingCollection((tfeat.SparseFeature("a", 8, 2), tfeat.DenseFeature("d")), generator=torch.Generator().manual_seed(0))
    x = {"a": torch.zeros(2, dtype=torch.int64), "d": torch.zeros(2)}
    with pytest.raises(ValueError, match="non-squeeze"):
        ec(x, (ec.features[1],))
    with pytest.raises(ValueError, match="cannot be empty"):
        ec(x, (), squeeze_dim=True)
    with pytest.raises(ValueError, match="concat"):
        temb.squeeze_width((tfeat.SequenceFeature("s", 8, 2, pooling="concat"),))
    assert temb.squeeze_width((tfeat.SparseFeature("a", 8, 2), tfeat.DenseFeature("d", 3))) == 5


def test_feature_schema_matches_jax():
    for v in (1, 2, 100, 10_000, 4_000_000):
        assert tfeat.auto_embedding_dim(v) == jfeat.auto_embedding_dim(v)
    assert tfeat.SparseFeature("a", 10_000).embed_dim == jfeat.SparseFeature("a", 10_000).embed_dim == 60
    assert tfeat.SequenceFeature("s", 81).embed_dim == 18
    with pytest.raises(ValueError, match="pooling"):
        tfeat.SequenceFeature("s", 8, pooling="max")
    with pytest.raises(Exception):
        tfeat.SparseFeature("a", 8).vocab_size = 9  # frozen
    fs = (tfeat.SparseFeature("a", 8), tfeat.DenseFeature("d"), tfeat.SequenceFeature("s", 8, shared_with="a"))
    assert [f.name for f in tfeat.embedded_features(fs)] == ["a", "s"]
    assert [f.name for f in tfeat.dense_features(fs)] == ["d"]
    assert [tfeat.table_name(f) for f in fs] == ["a", "d", "a"]
    assert repr(fs[0]) == repr(jfeat.SparseFeature("a", 8))
    assert isinstance(fs[0].initializer, tinit.RandomNormal) and fs[0].initializer == tinit.RandomNormal(0.0, 1e-4)


@pytest.mark.parametrize("spec", ["RandomNormal", "RandomUniform", "XavierNormal", "XavierUniform"])
def test_initializer_specs_draw_from_the_generator(spec):
    """The same distribution as the JAX spec (the RNG streams differ): mean and spread over
    a large draw, and the same values from the same seed."""
    args = {"RandomNormal": (0.5, 2.0), "RandomUniform": (-1.0, 3.0), "XavierNormal": (2.0,), "XavierUniform": (0.5,)}[spec]
    shape = (400, 100)
    got = getattr(tinit, spec)(*args)(shape, torch.Generator().manual_seed(0))
    ref = np.asarray(getattr(jinit, spec)(*args)(jax.random.PRNGKey(0), shape))
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.mean().item(), ref.mean(), atol=0.03 * ref.std() + 1e-6)
    np.testing.assert_allclose(got.std().item(), ref.std(), rtol=0.03)
    if "Uniform" in spec:
        np.testing.assert_allclose([got.min().item(), got.max().item()], [ref.min(), ref.max()], rtol=0.01, atol=0.01)
    assert torch.equal(got, getattr(tinit, spec)(*args)(shape, torch.Generator().manual_seed(0)))


def test_pretrained_initializer():
    w = np.arange(12, dtype=np.float64).reshape(4, 3)
    spec = tinit.Pretrained(weights=w)
    out = spec((4, 3))
    assert out.dtype == torch.float32 and np.array_equal(out.numpy(), w)
    with pytest.raises(ValueError, match="shape"):
        spec((3, 4))
    fea = tfeat.SparseFeature("p", 4, 3, padding_idx=1, initializer=spec)
    ec = temb.EmbeddingCollection((fea,))
    assert not ec.table("p")[1].any() and np.array_equal(ec.table("p")[2].detach().numpy(), w[2])
    assert np.array_equal(w, np.arange(12).reshape(4, 3))  # the caller's array untouched
