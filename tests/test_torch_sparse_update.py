"""The port's sparse row-wise embedding updates (``ops/sparse_update.py``) and their
gather hooks (``EmbeddingCollection``'s fused gather, HSTU's untied token table)
against the JAX package and against a dense gradient.

The updates are compared with ``jnp.unique``'s dedup and JAX's updates on the same
tables, ids and gradients (duplicates, an id equal to the fill row, negative ids,
weight decay), at the JAX package's tolerances (rtol 1e-5, atol 1e-6,
``tests/test_sparse_embedding.py``).  The hooks' recorded ids must equal the ids the
JAX hooks sow, bit for bit, and their row gradients JAX's perturbation gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_embedding import QUERIES, carried
from test_torch_seq_eval import MODEL_KW, seq_data
from torch_rechub_tpu.ops import sparse_update as jsu
from torch_rechub_tpu_torch.models.generative.hstu import HSTUModel
from torch_rechub_tpu_torch.ops import sparse_update as tsu
from torch_rechub_tpu_torch.trainers import sparse as tsparse
from torch_rechub_tpu_torch.utils.jax_weights import nest

RTOL, ATOL = 1e-5, 1e-6
# row gradients against a dense table gradient: the same products, summed per row in
# another order (index_add_ against the embedding backward's sorted segment sums)
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def table_ids_grads(seed, rows=65, n=24, dim=4, negative=True):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(rows, dim)).astype(np.float32)
    ids = rng.integers(-rows if negative else 0, rows - 1, n).astype(np.int32)
    return table, ids, rng.normal(size=(n, dim)).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def test_table_keys_and_split_match_jax():
    names = ["EmbeddingCollection_0.fused_d16_table", "EmbeddingCollection_0.C6_table", "fused_d8_table", "token_embedding", "output_projection", "MLP_0.Dense_0.weight"]
    for name in names:
        assert tsu.is_fused_table_key(name) == jsu.is_fused_table_key(name.rsplit(".", 1)[-1]), name
    assert not tsu.is_fused_table_key(None)
    params = {n: torch.zeros(1) for n in names}
    for extra in ((), ("token_embedding",), ("token_embedding", "output_projection")):
        tables, rest = tsu.split_fused_tables(params.items(), extra)
        jtables, jrest = jsu.split_fused_tables(nest({tuple(n.split(".")): np.zeros(1) for n in names}), extra)
        assert set(tables) == {".".join(k) for k in jtables} and set(rest) == {".".join(k) for k in jrest}, extra


@pytest.mark.parametrize("seed", range(4))
def test_dedup_matches_jnp_unique(seed):
    """Sorted distinct ids padded with the fill value, and the inverse, as jnp.unique(size=n) gives them:
    negative ids, ids equal to the fill row, and (seed 3) no ids at all."""
    rng = np.random.default_rng(seed)
    n = 0 if seed == 3 else 40
    ids = rng.integers(-12, 12, n).astype(np.int32)
    for fill in (11, 0, -3):
        u, inv = jnp.unique(jnp.asarray(ids), size=n, fill_value=fill, return_inverse=True)
        tu, tinv = tsu.unique_with_fill(t(ids).long(), fill)
        np.testing.assert_array_equal(tu.numpy(), np.asarray(u))
        np.testing.assert_array_equal(tinv.numpy(), np.asarray(inv).reshape(-1))


@pytest.mark.parametrize("weight_decay", [0.0, 0.1], ids=["plain", "weight_decay"])
def test_sparse_sgd_matches_dense_sgd_and_jax(weight_decay):
    table, ids, grads = table_ids_grads(0)
    ids[:4] = [3, 3, -1, 64]  # duplicates; -1 and 64 both address the last row
    lr = 0.1
    ref = np.asarray(jsu.sparse_sgd_update(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(grads), lr, weight_decay))
    got = tsu.sparse_sgd_update(t(table), t(ids), t(grads), lr, weight_decay).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    if not weight_decay:  # dense SGD on the dense gradient
        dense = np.zeros_like(table)
        np.add.at(dense, ids % table.shape[0], grads)
        np.testing.assert_allclose(got, table - lr * dense, rtol=RTOL, atol=ATOL)


def test_rowwise_adagrad_dedup_semantics():
    """tests/test_sparse_embedding.py::test_rowwise_adagrad_dedup_semantics: duplicate rows are summed
    first, one accumulator update per row, the spare row and untouched rows unchanged."""
    rng = np.random.default_rng(1)
    table = rng.normal(size=(65, 4)).astype(np.float32)  # row 64 is the spare
    ids = np.array([2, 5, 2, 9])
    grads = rng.normal(size=(4, 4)).astype(np.float32)
    lr, eps = 0.05, 1e-10
    new_table, new_accum = tsu.rowwise_adagrad_update(t(table), torch.zeros(65), t(ids), t(grads), lr, eps=eps)
    agg = np.zeros((65, 4), np.float32)
    for i, g in zip(ids, grads):
        agg[i] += g
    exp_table, exp_accum = table.copy(), np.zeros(65, np.float32)
    for r in sorted(set(ids.tolist())):
        exp_accum[r] = np.mean(agg[r] ** 2)
        exp_table[r] -= lr / (np.sqrt(exp_accum[r]) + eps) * agg[r]
    np.testing.assert_allclose(new_accum.numpy(), exp_accum, rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(new_table.numpy(), exp_table, rtol=RTOL, atol=ATOL)
    untouched = [r for r in range(65) if r not in ids]
    np.testing.assert_array_equal(new_table.numpy()[untouched], table[untouched])


ADAGRAD_CASES = {
    "duplicates": dict(),
    "fill_id": dict(fill_ids=True),  # recorded ids equal to the spare last row: no update there
    "negative_ids": dict(negative=True),  # -1 wraps onto the spare row, yet is a valid id of its own
    "weight_decay": dict(weight_decay=0.01, negative=True),
    "spare_row_0": dict(spare_row=0, fill_ids=True),  # HSTU's PAD row
    "accumulated": dict(accum=True, negative=True),
}


@pytest.mark.parametrize("case", ADAGRAD_CASES, ids=list(ADAGRAD_CASES))
def test_rowwise_adagrad_matches_jax(case):
    kw = ADAGRAD_CASES[case]
    table, ids, grads = table_ids_grads(2, negative=kw.get("negative", False))
    spare = kw.get("spare_row", -1)
    fill = table.shape[0] - 1 if spare < 0 else spare
    ids[:3] = ids[3]  # duplicates
    if kw.get("fill_ids"):
        ids[5:7] = fill
    if kw.get("negative"):
        ids[8:10] = [-1, -2]
    accum = np.random.default_rng(3).uniform(0, 2, table.shape[0]).astype(np.float32) if kw.get("accum") else np.zeros(table.shape[0], np.float32)
    wd, lr = kw.get("weight_decay", 0.0), 0.05
    jt, ja = jsu.rowwise_adagrad_update(jnp.asarray(table), jnp.asarray(accum), jnp.asarray(ids), jnp.asarray(grads), lr, weight_decay=wd, spare_row=spare)
    tt, ta = tsu.rowwise_adagrad_update(t(table), t(accum), t(ids), t(grads), lr, weight_decay=wd, spare_row=spare)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=RTOL, atol=ATOL)
    if kw.get("fill_ids") and not kw.get("negative"):
        np.testing.assert_array_equal(tt.numpy()[fill], table[fill])
        assert ta[fill] == accum[fill]
    untouched = sorted(set(range(table.shape[0])) - set((ids % table.shape[0]).tolist()))
    np.testing.assert_array_equal(tt.numpy()[untouched], table[untouched])
    np.testing.assert_array_equal(ta.numpy()[untouched], accum[untouched])


def test_updates_of_no_ids_change_nothing():
    table, _, _ = table_ids_grads(4)
    ids, grads = torch.zeros(0, dtype=torch.int64), torch.zeros(0, 4)
    tt, ta = tsu.rowwise_adagrad_update(t(table), torch.zeros(65), ids, grads, 0.1)
    assert torch.equal(tt, t(table)) and not ta.any()
    assert torch.equal(tsu.sparse_sgd_update(t(table), ids, grads, 0.1), t(table))


def test_init_accumulators():
    tables = {"a.fused_d8_table": torch.ones(5, 8, dtype=torch.float64), "token_embedding": torch.ones(3, 2)}
    accums = tsu.init_accumulators(tables)
    ref = jsu.init_accumulators({k: np.ones(v.shape) for k, v in tables.items()})
    for name, a in accums.items():
        assert a.dtype == torch.float32 and a.shape == (tables[name].shape[0],) and not a.any()
        assert np.asarray(ref[name]).shape == tuple(a.shape) and np.asarray(ref[name]).dtype == np.float32


def test_sites_of_one_table_update_together():
    """apply_sparse_table_updates concatenates every record of a table (the sampled softmax's labels
    and negatives) before one Adagrad update: a row in both sites is one distinct id, not two."""
    table, ids, grads = table_ids_grads(5, negative=False)
    rows = [torch.from_numpy(grads[:12]).requires_grad_(), torch.from_numpy(grads[12:]).requires_grad_()]
    for r in rows:
        r.grad = r.detach() * 1.0
    records = [("t", t(ids[:12]), rows[0]), ("t", t(ids[12:]), rows[1])]
    tables, accums = {"t": t(table)}, {"t": torch.zeros(table.shape[0])}
    tsparse.apply_sparse_table_updates(tables, accums, records, "adagrad", 0.05)
    ref_t, ref_a = tsu.rowwise_adagrad_update(t(table), torch.zeros(table.shape[0]), t(ids), t(grads), 0.05)
    assert torch.equal(tables["t"], ref_t) and torch.equal(accums["t"], ref_a)
    with pytest.raises(ValueError, match="sparse_embedding"):
        tsparse.validate_method("adam")


# ---------------------------------------------------------------------------
# the gather hooks
# ---------------------------------------------------------------------------

def test_fused_gather_hook_records_jax_ids_and_perturbation_grads():
    """EmbeddingCollection under fused=True on every kind of feature (padding_idx, shared tables,
    -1 padding that reads the previous owner's rows, a negative id, the three poolings): the recorded ids are
    the ids JAX sows, the leaf's gradient JAX's perturbation gradient, the fused table's .grad stays
    None, and the row gradients scattered into a table equal the port's dense table gradient."""
    jec, params, tec, js, ts, x = carried(True)
    x["a"][0] = -1  # "a" is the first owner: -1 + its offset 0 stays negative, and reads the spare row
    keys, squeeze = QUERIES["stacked"]
    jfeats, tfeats = tuple(js[k] for k in keys), tuple(ts[k] for k in keys)
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    out_shape = jax.eval_shape(lambda: jec.apply({"params": params}, jx, jfeats)).shape
    cot = np.random.default_rng(6).normal(size=out_shape).astype(np.float32)

    pert_shapes = jax.eval_shape(lambda: jec.apply({"params": params}, jx, jfeats, mutable=["perturbations"])[1])["perturbations"]
    perts = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), pert_shapes)

    def jloss(perts):
        out, mut = jec.apply({"params": params, "perturbations": perts}, jx, jfeats, mutable=["embedding_ids"])
        return jnp.sum(out * cot), mut["embedding_ids"]

    g_pert, ids_tree = jax.grad(jloss, has_aux=True)(perts)
    (jkey, jids, jgrads), = list(jsu.pair_sparse_grads({"p": g_pert}, {"p": ids_tree}))

    table = tec.fused_d8_table
    with tsu.record_rows({"fused_d8_table": table}) as rec:
        out = tec(tx, tfeats, squeeze_dim=squeeze)
    (out * torch.from_numpy(cot)).sum().backward()
    assert table.grad is None
    (name, ids, grads), = list(tsu.pair_sparse_grads(rec.records))
    assert name == "fused_d8_table" == jkey[-1]
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert (ids < 0).any()  # unwrapped, as JAX sows it
    np.testing.assert_allclose(grads.numpy(), np.asarray(jgrads), rtol=GRAD_RTOL, atol=GRAD_ATOL)

    dense_out = tec(tx, tfeats, squeeze_dim=squeeze)
    np.testing.assert_array_equal(dense_out.detach().numpy(), out.detach().numpy())  # the hook changes no value
    (dense_out * torch.from_numpy(cot)).sum().backward()
    scattered = torch.zeros_like(table).index_add_(0, torch.where(ids < 0, ids + table.shape[0], ids).long(), grads)
    np.testing.assert_allclose(scattered.numpy(), table.grad.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_per_feature_tables_take_no_hook():
    """Only fused tables are hooked: per-feature tables keep their dense gradient inside a recorder."""
    _, _, tec, _, ts, x = carried("auto")
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    tables, _ = tsu.split_fused_tables(tec.named_parameters())
    assert list(tables) == ["fused_d8_table"]
    with tsu.record_rows(tables) as rec:
        tec(tx, tuple(ts[k] for k in QUERIES["stacked"][0])).sum().backward()
    assert [r[0] for r in rec.records] == ["fused_d8_table"] and tec.fused_d8_table.grad is None
    assert tec.a_table.grad is not None and tec.a_table.grad.any()
    assert tsu.gather_rows(tec.fused_d8_table, torch.tensor([1])).grad_fn is not None  # closed: plain indexing, no recorded leaf


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_hstu_token_hook(tie):
    """The untied HSTU's token gather records ``x`` and the rows' gradient, which scattered into a table
    equals the dense gradient of token_embedding (PAD row 0 included: zero); a tied model records nothing."""
    toks, _, _, tds = seq_data(n=4, seed=7)
    model = HSTUModel(**MODEL_KW, tie_embeddings=tie, generator=torch.Generator().manual_seed(0))
    x, td = torch.from_numpy(toks), torch.from_numpy(tds)
    cot = torch.from_numpy(np.random.default_rng(8).normal(size=(4, toks.shape[1], MODEL_KW["d_model"])).astype(np.float32))
    with tsu.record_rows({"token_embedding": model.token_embedding}) as rec:
        hidden = model(x, td, return_hidden=True)["hidden"]
    (hidden * cot).sum().backward()
    if tie:
        assert rec.records == [] and model.token_embedding.grad is not None
        return
    assert model.token_embedding.grad is None
    (name, ids, grads), = list(tsu.pair_sparse_grads(rec.records))
    assert name == "token_embedding" and torch.equal(ids, x.reshape(-1).long())
    dense_hidden = model(x, td, return_hidden=True)["hidden"]
    np.testing.assert_array_equal(dense_hidden.detach().numpy(), hidden.detach().numpy())
    (dense_hidden * cot).sum().backward()
    scattered = torch.zeros_like(model.token_embedding).index_add_(0, ids, grads)
    assert (toks == 0).any() and not scattered[0].any()
    np.testing.assert_allclose(scattered.numpy(), model.token_embedding.grad.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL)
