"""The port's sparse training steps (``CTRTrainer`` / ``SeqTrainer(sparse_embedding=...)``)
against the JAX package's, and against a dense gradient.

One CTR step from carried weights is compared as ``tests/test_torch_ctr_train.py``
compares a dense one: the loss, every dense parameter after Adam (allowed what the
first step's update rule makes of a gradient's rounding), the BatchNorm statistics,
and here the fused table and its accumulators.  A step after carrying a JAX run's
state (its parameters, its Adam moments over the rest and its accumulators) is held
to the tolerances of ``test_one_step_after_carrying_jax_adam_state``.  The sampled
softmax draws its negatives from another RNG in each package, so its test hands both
the same candidate ids.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ctr_model import MLP_PARAMS, np_tree, schema
from test_torch_cuda_sparse import step_ratio
from test_torch_ctr_train import ADAM_RTOL, ADAM_UPDATE_TOL, BN_INVARIANT, GRAD_ATOL_REL, GRAD_RTOL, LOSS_ATOL, LOSS_RTOL, LR, NOISE_REL, REG, STATS_ATOL, STATS_RTOL, first_update, labelled
from test_torch_seq_eval import MODEL_KW, VOCAB, seq_data
from torch_rechub_tpu.basic import features as jfeat
from torch_rechub_tpu.basic.loss import RegularizationLoss as JRegularizationLoss
from torch_rechub_tpu.basic.loss import bce_with_logits as jbce
from torch_rechub_tpu.models.generative.hstu import HSTUModel as JHSTUModel
from torch_rechub_tpu.models.ranking import DeepFM as JDeepFM
from torch_rechub_tpu.ops import chunked_ce as jce
from torch_rechub_tpu.ops import embedding as jemb
from torch_rechub_tpu.ops import sparse_update as jsu
from torch_rechub_tpu.trainers.ctr_trainer import CTRTrainer as JCTRTrainer
from torch_rechub_tpu.trainers.seq_trainer import SeqTrainer as JSeqTrainer
from torch_rechub_tpu.utils import data as jdata
from torch_rechub_tpu_torch.basic import features as tfeat
from torch_rechub_tpu_torch.models.generative.hstu import HSTUModel
from torch_rechub_tpu_torch.models.ranking import DeepFM
from torch_rechub_tpu_torch.ops import chunked_ce as tce
from torch_rechub_tpu_torch.ops import embedding as temb
from torch_rechub_tpu_torch.trainers import CTRTrainer, SeqTrainer
from torch_rechub_tpu_torch.utils import data as tdata
from torch_rechub_tpu_torch.utils.jax_weights import flax_to_state_dict, load_flax_params, load_optax_adam_state, load_sparse_accumulators

# tables and accumulators after one step: the JAX package's tolerances (tests/test_sparse_embedding.py)
TABLE_RTOL, TABLE_ATOL = 1e-5, 1e-6
# a step from a carried state: test_torch_seq_train.py::test_one_step_after_carrying_jax_adam_state
CARRIED_RTOL, CARRIED_ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def fused_default(request):
    """Both packages' default table layout; ``True`` fuses the tiny test tables so they take sparse updates."""
    layout = getattr(request, "param", True)
    old = (jemb.set_fused_default(layout), temb.set_fused_default(layout))
    yield layout
    jemb.set_fused_default(old[0])
    temb.set_fused_default(old[1])


def adam_state(opt_state):
    (adam,) = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")]
    return adam


# ---------------------------------------------------------------------------
# CTRTrainer
# ---------------------------------------------------------------------------

def carried_sparse_ctr(tmp_path, method, big=False, optimizer_params=None, regularization_params=None, mlp_params=MLP_PARAMS):
    """A sparse JAX CTRTrainer initialised on a batch, and the port's on its carried variables."""
    (js, jd), (ts, td) = schema(jfeat, big), schema(tfeat, big)
    jtrainer = JCTRTrainer(JDeepFM(deep_features=jd + js, fm_features=js, mlp_params=mlp_params), optimizer_params=optimizer_params, regularization_params=regularization_params, model_path=str(tmp_path / "jax"), sparse_embedding=method)
    x, y = table_batch(8, seed=0, big=big)
    jtrainer._ensure_ready(jdata.ArrayLoader(x, y, batch_size=64))
    model = load_flax_params(DeepFM(td + ts, ts, mlp_params), np_tree(jtrainer.state.params), np_tree(jtrainer.state.batch_stats))
    trainer = CTRTrainer(model, optimizer_params=optimizer_params, regularization_params=regularization_params, model_path=str(tmp_path / "torch"), sparse_embedding=method, device="cpu")
    return jtrainer, trainer


def table_batch(n, seed, big=False):
    x, y = labelled(n, seed)
    if big:
        x["C_big"] = np.random.default_rng(seed + 7).integers(0, 262144, n).astype(np.int32)
    return x, y


CTR_STEP_CASES = {
    "sgd": ("sgd", True, None, None),
    "adagrad": ("adagrad", True, None, None),
    # "auto" fuses only C_big: the five per-feature tables stay on the optimizer (Adagrad here) and take
    # the embedding L1 / L2 terms; the fused table takes neither
    "adagrad_auto_split_regularized": ("adagrad", "auto", {"lr": LR, "weight_decay": 1e-5, "embedding_optimizer": "adagrad"}, REG),
}


@pytest.mark.parametrize("fused_default,case", [(v[1], k) for k, v in CTR_STEP_CASES.items()], ids=list(CTR_STEP_CASES), indirect=["fused_default"])
def test_sparse_ctr_step_matches_jax(tmp_path, fused_default, case):
    """One sparse step on a partial batch of 50 padded to 64, from carried weights: the loss, the dense
    parameters after the optimizer, the fused table and its accumulators, the BatchNorm statistics;
    under "sgd" the table is also table - lr * (the dense table gradient)."""
    method, layout, optimizer_params, reg = CTR_STEP_CASES[case]
    big = layout == "auto"
    jtrainer, trainer = carried_sparse_ctr(tmp_path, method, big, optimizer_params, reg)
    params0, stats0 = np_tree(jtrainer.state.params), np_tree(jtrainer.state.batch_stats)
    x, y = table_batch(50, seed=1, big=big)

    # the JAX step's gradients: its loss on the padded batch, regularization over the rest only
    xp, yp, w = jdata.pad_batch(x, y, 64)
    jreg = JRegularizationLoss(**(reg or {}))

    def jloss(p):
        out, _ = jtrainer.model.apply({"params": p, "batch_stats": stats0}, {k: jnp.asarray(v) for k, v in xp.items()}, training=True, mutable=["batch_stats"])
        _, rest = jsu.split_fused_tables(p)
        return jbce(out, jnp.asarray(yp), jnp.asarray(w)) + (jreg(jsu.merge_params({}, rest)) if jreg else 0.0)

    ref_loss, jgrads = jax.value_and_grad(jloss)(params0)
    reg_grads = flax_to_state_dict(np_tree(jax.grad(lambda p: jreg(jsu.merge_params({}, jsu.split_fused_tables(p)[1])))(params0))) if jreg else {}
    jloss_step = jtrainer.train_one_epoch(jdata.ArrayLoader(x, y, batch_size=64), log_interval=0)
    loss = trainer.train_one_epoch(tdata.ArrayLoader(x, y, batch_size=64), log_interval=0)
    np.testing.assert_allclose(jloss_step, float(ref_loss), rtol=1e-6)
    np.testing.assert_allclose(loss, jloss_step, rtol=LOSS_RTOL, atol=LOSS_ATOL)

    grads, before, after = (flax_to_state_dict(t) for t in (np_tree(jgrads), params0, np_tree(jtrainer.state.params)))
    (table_name,) = trainer.sparse_tables
    table = trainer.sparse_tables[table_name]
    assert table_name.endswith("fused_d8_table") and table.grad is None
    stepped = {id(p) for g in trainer.optimizer.param_groups for p in g["params"]}
    optimizer_states = [s for opt in getattr(trainer.optimizer, "optimizers", [trainer.optimizer]) for s in opt.state]
    assert id(table) not in stepped and all(s is not table for s in optimizer_states)

    emb_rule = (optimizer_params or {}).get("embedding_optimizer")
    floor = NOISE_REL * max(float(g.abs().max()) for name, g in grads.items() if name != table_name)
    for name, p in trainer.model.named_parameters():
        if name == table_name:
            continue
        g, r, p0 = p.grad.numpy(), grads[name].numpy(), before[name].numpy()
        if name in BN_INVARIANT:  # what is left of the gradient is the regularization's
            exact = reg_grads[name].numpy() if name in reg_grads else 0.0
            assert np.abs(g - exact).max() < floor and np.abs(r - exact).max() < floor, name
            grad_tol = floor
        else:
            grad_tol = GRAD_RTOL * np.abs(r) + GRAD_ATOL_REL * float(np.abs(r).max()) + 1e-12
            np.testing.assert_allclose(g, r, rtol=GRAD_RTOL, atol=GRAD_ATOL_REL * float(np.abs(r).max()) + 1e-12, err_msg=name)
        rule = emb_rule if emb_rule and name.endswith("_table") else "adam"
        wd = (optimizer_params or {"weight_decay": 1e-5})["weight_decay"]
        u_ref = first_update(r, p0, rule, wd)
        jitted = np.maximum(*(np.abs(first_update(r + s * grad_tol, p0, rule, wd) - u_ref) for s in (-1, 1)))
        carried = LR * (np.abs(first_update(g, p0, rule, wd) - u_ref) + jitted)
        got, ref = p.detach().numpy(), after[name].numpy()
        bad = np.abs(got - ref) > ADAM_UPDATE_TOL * LR + ADAM_RTOL * np.abs(ref) + carried
        assert not bad.any(), (name, got[bad][:4], ref[bad][:4])

    np.testing.assert_allclose(table.detach().numpy(), after[table_name].numpy(), rtol=TABLE_RTOL, atol=TABLE_ATOL)
    t0 = before[table_name]
    # the table's step itself, which at lr 1e-3 can lie below TABLE_ATOL: -lr times the gradient under "sgd"
    step_rtol = GRAD_RTOL if method == "sgd" else 2 * GRAD_RTOL
    assert step_ratio(table, t0, after[table_name].double() - t0.double(), step_rtol, GRAD_ATOL_REL) <= 1.0
    jaccum = flax_to_state_dict(np_tree(jtrainer.state.opt_state[1]))[table_name].numpy()
    np.testing.assert_allclose(trainer.sparse_accums[table_name].numpy(), jaccum, rtol=TABLE_RTOL, atol=TABLE_ATOL * float(jaccum.max()))
    if method == "sgd":  # sparse SGD is dense SGD on the dense table gradient
        assert not trainer.sparse_accums[table_name].any()
        np.testing.assert_allclose(table.detach().numpy(), t0.numpy() - LR * grads[table_name].numpy(), rtol=TABLE_RTOL, atol=TABLE_ATOL)
        assert step_ratio(table, t0, -LR * grads[table_name].double(), GRAD_RTOL, GRAD_ATOL_REL) <= 1.0
    t0 = t0.numpy()
    touched = np.abs(grads[table_name].numpy()).max(axis=1) > 0
    assert touched.any() and (table.detach().numpy()[touched] != t0[touched]).any()
    np.testing.assert_array_equal(table.detach().numpy()[~touched], t0[~touched])  # untouched rows bit for bit
    ref_stats = flax_to_state_dict(np_tree(jtrainer.state.batch_stats))
    for name, b in trainer.model.named_buffers():
        np.testing.assert_allclose(b.numpy(), ref_stats[name].numpy(), rtol=STATS_RTOL, atol=STATS_ATOL, err_msg=name)


@pytest.mark.usefixtures("fused_default")
def test_sparse_ctr_step_after_carrying_a_jax_sparse_state(tmp_path):
    """JAX takes two row-wise Adagrad steps; its parameters, its Adam moments over the rest and its
    accumulators are carried into the port; both take the third step on the same batch.  The MLP has
    no hidden layer, so no BatchNorm makes a bias's gradient rounding noise."""
    jtrainer, trainer = carried_sparse_ctr(tmp_path, "adagrad", mlp_params={"dims": ()})
    x, y = labelled(192, seed=15)
    jtrainer.train_one_epoch(jdata.ArrayLoader({k: v[:128] for k, v in x.items()}, y[:128], batch_size=64), log_interval=0)
    adam = adam_state(jtrainer.state.opt_state[0])
    assert int(adam.count) == 2
    model = load_flax_params(trainer.model, np_tree(jtrainer.state.params), np_tree(jtrainer.state.batch_stats))
    load_optax_adam_state(trainer.optimizer, model, np_tree(adam.mu), np_tree(adam.nu), adam.count)
    load_sparse_accumulators(trainer.sparse_accums, np_tree(jtrainer.state.opt_state[1]))
    (table_name,) = trainer.sparse_tables
    assert trainer.sparse_accums[table_name].any()
    third = ({k: v[128:] for k, v in x.items()}, y[128:])
    jloss = jtrainer.train_one_epoch(jdata.ArrayLoader(*third, batch_size=64), log_interval=0)
    loss = trainer.train_one_epoch(tdata.ArrayLoader(*third, batch_size=64), log_interval=0)
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert all(int(s["step"]) == 3 for s in trainer.optimizer.state.values())
    for name, ref in flax_to_state_dict(np_tree(jtrainer.state.params)).items():
        np.testing.assert_allclose(dict(model.named_parameters())[name].detach().numpy(), ref.numpy(), rtol=CARRIED_RTOL, atol=CARRIED_ATOL, err_msg=name)
    jaccum = flax_to_state_dict(np_tree(jtrainer.state.opt_state[1]))[table_name].numpy()
    np.testing.assert_allclose(trainer.sparse_accums[table_name].numpy(), jaccum, rtol=CARRIED_RTOL, atol=CARRIED_ATOL * float(jaccum.max()))
    with pytest.raises(ValueError, match="accumulators"):
        load_sparse_accumulators({"other": torch.zeros(3)}, np_tree(jtrainer.state.opt_state[1]))


def build_ctr(n=256, vocab=64, seed=0):
    """tests/test_sparse_embedding.py::build_ctr: the label from C0's parity and I0."""
    rng = np.random.default_rng(seed)
    x = {f"C{i}": rng.integers(0, vocab, n).astype(np.int32) for i in range(4)}
    x["I0"] = rng.normal(size=n).astype(np.float32)
    y = ((x["C0"] % 2) * 2.0 - 1.0 + x["I0"] + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    sparse = tuple(tfeat.SparseFeature(f"C{i}", vocab_size=vocab, embed_dim=8) for i in range(4))
    model = DeepFM((tfeat.DenseFeature("I0"),), sparse, {"dims": (16,), "dropout": 0.0}, generator=torch.Generator().manual_seed(seed))
    return model, x, y


@pytest.mark.usefixtures("fused_default")
@pytest.mark.parametrize("method", ["sgd", "adagrad"])
def test_sparse_trainer_learns(tmp_path, method):
    """tests/test_sparse_embedding.py::test_sparse_trainer_learns: the loss falls, the AUC passes 0.6,
    and the fused table's padding rows (no id reaches them) stay zero."""
    model, x, y = build_ctr(n=512)
    lr = {"sgd": 1e-2, "adagrad": 1e-3}[method]
    trainer = CTRTrainer(model, n_epoch=3, model_path=str(tmp_path), sparse_embedding=method, steps_per_call=2, optimizer_params={"lr": lr}, device="cpu")
    dl = tdata.ArrayLoader(x, y, batch_size=64, shuffle=False)
    first = trainer.train_one_epoch(dl, log_interval=0)
    for _ in range(2):
        last = trainer.train_one_epoch(dl, log_interval=0)
    assert last < first, (first, last)
    assert trainer.evaluate(model, dl) > 0.6
    table = model.EmbeddingCollection_0.fused_d8_table
    assert table.grad is None and not table[4 * 64:].any()


def test_sparse_requires_a_fused_table(tmp_path):
    old = temb.set_fused_default(False)
    try:
        model, _, _ = build_ctr()
    finally:
        temb.set_fused_default(old)
    with pytest.raises(ValueError, match=r"set_fused_default\(True\)"):
        CTRTrainer(model, model_path=str(tmp_path), sparse_embedding="sgd", device="cpu")
    with pytest.raises(ValueError, match="sparse_embedding must be"):
        CTRTrainer(model, model_path=str(tmp_path), sparse_embedding="adam", device="cpu")


# ---------------------------------------------------------------------------
# SeqTrainer
# ---------------------------------------------------------------------------

def test_seq_sparse_requires_untied():
    with pytest.raises(ValueError, match="tie_embeddings"):
        SeqTrainer(HSTUModel(**MODEL_KW, tie_embeddings=True), sparse_embedding="sgd", device="cpu")


SEQ_LOSSES = {"cross_entropy": ("cross_entropy", None), "chunked": ("cross_entropy", 16), "nce": ("nce", None), "sampled": ("sampled_softmax", None)}


@pytest.mark.parametrize("loss", SEQ_LOSSES)
def test_seq_sparse_sgd_step_equals_dense_grad(loss):
    """One sparse-SGD step: each sparse table equals table - lr * its dense gradient (the same weights
    and the same seeded generator, so the sampled softmax draws the same negatives); PAD row 0 stays 0;
    the dense optimizer holds no sparse table (the output projection is one under the sampled softmax)."""
    loss_type, chunk = SEQ_LOSSES[loss]
    toks, _, tgts, tds = seq_data(n=8, seed=20)
    assert (toks == 0).any()
    lr = 0.05
    kw = dict(loss_type=loss_type, vocab_chunk_size=chunk, optimizer_params={"lr": lr}, loss_params={"num_negatives": 24} if loss == "sampled" else None, device="cpu")
    sparse = SeqTrainer(HSTUModel(**MODEL_KW, tie_embeddings=False, generator=torch.Generator().manual_seed(3)), sparse_embedding="sgd", **kw)
    dense = SeqTrainer(HSTUModel(**MODEL_KW, tie_embeddings=False), **kw)
    dense.model.load_state_dict(sparse.model.state_dict())
    expected_tables = {"token_embedding", "output_projection"} if loss == "sampled" else {"token_embedding"}
    assert set(sparse.sparse_tables) == expected_tables
    stepped = {id(p) for g in sparse.optimizer.param_groups for p in g["params"]}
    assert not stepped & {id(p) for p in sparse.sparse_tables.values()}
    before = {k: v.detach().clone() for k, v in sparse.sparse_tables.items()}

    batch = [torch.from_numpy(a) for a in (toks, tds, tgts)]
    dense.model.train()
    dense.loss_fn(*batch).backward()
    sparse.train_step(*batch)
    for name, table in sparse.sparse_tables.items():
        assert table.grad is None
        ref = before[name] - lr * getattr(dense.model, name).grad
        np.testing.assert_allclose(table.detach().numpy(), ref.numpy(), rtol=TABLE_RTOL, atol=TABLE_ATOL, err_msg=name)
        assert not table.detach()[0].any() or name == "output_projection", name
    assert not sparse.sparse_accums["token_embedding"].any()


@pytest.mark.parametrize("method", ["sgd", "adagrad"])
def test_seq_sparse_learns_chunked(method):
    """tests/test_sparse_embedding.py::test_seq_sparse_learns_chunked: the sparse input table with the
    chunked CE, three epochs, the loss falls."""
    toks, pos, tgts, tds = seq_data(n=32, seed=21)
    trainer = SeqTrainer(HSTUModel(**MODEL_KW, tie_embeddings=False, generator=torch.Generator().manual_seed(4)), sparse_embedding=method, vocab_chunk_size=16, steps_per_call=2, optimizer_params={"lr": 1e-2}, device="cpu")
    loader = tdata.SeqLoader(toks, pos, tgts, tds, batch_size=32)
    losses = [trainer.train_one_epoch(loader, log_interval=0) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert not trainer.model.token_embedding[0].any()


SAMPLED_KW = dict(tie_embeddings=False, score_norm="l2", temperature=0.5)


def test_seq_sampled_sparse_step_matches_jax(tmp_path, monkeypatch):
    """The sampled softmax with both tables sparse (row-wise Adagrad), on unpadded sequences
    (``score_norm="l2"`` gives JAX NaN gradients on PAD) and injected candidate ids: JAX takes two steps,
    its state (parameters, Adam over the rest, both tables' accumulators) is carried into the port, and
    both take the third."""
    rng = np.random.default_rng(22)
    toks, pos, tgts, tds = seq_data(n=24, seed=23)
    toks = rng.integers(1, VOCAB, toks.shape).astype(np.int32)
    negs = rng.integers(1, VOCAB, 24)
    negs[:3] = tgts[:3]  # accidental hits
    jdraw, tdraw = jce.sampled_candidates, tce.sampled_candidates  # the labels as drawn, the negatives injected
    monkeypatch.setattr(jce, "sampled_candidates", lambda *a: (jdraw(*a)[0], jnp.asarray(negs, jnp.int32)))
    monkeypatch.setattr(tce, "sampled_candidates", lambda *a: (tdraw(*a)[0], torch.from_numpy(negs)))
    kw = dict(loss_type="sampled_softmax", loss_params={"num_negatives": 24}, sparse_embedding="adagrad")
    jtrainer = JSeqTrainer(JHSTUModel(**MODEL_KW, **SAMPLED_KW), n_epoch=1, model_path=str(tmp_path), **kw)
    jtrainer.train_one_epoch(jdata.SeqLoader(toks[:16], pos[:16], tgts[:16], tds[:16], batch_size=8), log_interval=0)
    adam = adam_state(jtrainer.state.opt_state[0])
    assert int(adam.count) == 2
    model = load_flax_params(HSTUModel(**MODEL_KW, **SAMPLED_KW), np_tree(jtrainer.state.params))
    trainer = SeqTrainer(model, device="cpu", **kw)
    load_optax_adam_state(trainer.optimizer, model, np_tree(adam.mu), np_tree(adam.nu), adam.count)
    load_sparse_accumulators(trainer.sparse_accums, np_tree(jtrainer.state.opt_state[1]))
    assert set(trainer.sparse_accums) == {"token_embedding", "output_projection"} and all(a.any() for a in trainer.sparse_accums.values())
    third = (toks[16:], pos[16:], tgts[16:], tds[16:])
    jloss = jtrainer.train_one_epoch(jdata.SeqLoader(*third, batch_size=8), log_interval=0)
    loss = trainer.train_one_epoch(tdata.SeqLoader(*third, batch_size=8), log_interval=0)
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    for name, ref in flax_to_state_dict(np_tree(jtrainer.state.params)).items():
        np.testing.assert_allclose(dict(model.named_parameters())[name].detach().numpy(), ref.numpy(), rtol=CARRIED_RTOL, atol=CARRIED_ATOL, err_msg=name)
    for name, ref in flax_to_state_dict(np_tree(jtrainer.state.opt_state[1])).items():
        np.testing.assert_allclose(trainer.sparse_accums[name].numpy(), ref.numpy(), rtol=CARRIED_RTOL, atol=CARRIED_ATOL * float(ref.numpy().max()), err_msg=name)
