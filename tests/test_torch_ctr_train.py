"""The port's CTR training path (``CTRTrainer`` steps on padded batches,
Adam with the embedding-table split, regularization, the loaders, fit /
evaluate / predict, early stopping, checkpoints) against the JAX package.

A step is compared from the same carried weights on one padded partial
batch: the loss, every parameter's gradient, every parameter after the
optimizer and the BatchNorm statistics.  Adam's first step is
``lr * g / (|g| + eps)``, about ``lr * sign(g)``: it turns a gradient's
rounding noise into a move of up to ``2 * lr`` where the gradient is near
0 (the Dense biases in front of a BatchNorm have an exact gradient of 0,
since the batch mean removes them).  The gradient the JAX trainer's jitted
step takes is not the one ``jax.value_and_grad`` gives here either: XLA
orders its sums another way.  So a parameter after the step is held to
Adam's tolerance plus what the update rule makes of a gradient difference
within the gradient tolerance: ``lr * |u(g_port) - u(g_jax)|`` and the
most that ``lr * u`` moves when ``g_jax`` moves by that tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import synthetic_ctr_frame
from test_torch_ctr_model import MLP_PARAMS, N_SPARSE, VOCAB, carried_deepfm, ctr_batch, np_tree, schema
from torch_rechub_tpu.basic import features as jfeat
from torch_rechub_tpu.basic.loss import RegularizationLoss as JRegularizationLoss
from torch_rechub_tpu.basic.loss import bce_with_logits as jbce
from torch_rechub_tpu.models.ranking import DeepFM as JDeepFM
from torch_rechub_tpu.trainers import base as jbase
from torch_rechub_tpu.trainers.ctr_trainer import CTRTrainer as JCTRTrainer
from torch_rechub_tpu.utils import data as jdata
from torch_rechub_tpu_torch.basic import features as tfeat
from torch_rechub_tpu_torch.basic.tracking import BaseLogger
from torch_rechub_tpu_torch.models.ranking import DeepFM
from torch_rechub_tpu_torch.trainers import CTRTrainer
from torch_rechub_tpu_torch.trainers import base as tbase
from torch_rechub_tpu_torch.utils import data as tdata
from torch_rechub_tpu_torch.utils.jax_weights import flax_to_state_dict, load_flax_params, load_optax_adam_state

# the tolerances of tests/test_torch_seq_train.py for the same quantities
LOSS_RTOL, LOSS_ATOL = 2e-5, 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 2e-4, 1e-4
ADAM_RTOL, ADAM_UPDATE_TOL = 1e-6, 3e-5
# the BatchNorm statistics: the forward's tolerance (test_torch_ctr_model.py)
STATS_RTOL, STATS_ATOL = 1e-5, 1e-6
# the Dense biases in front of a BatchNorm: the loss gives them an exact gradient of 0, both
# packages' are rounding noise below this share of the model's largest gradient
BN_INVARIANT, NOISE_REL = ("MLP_0.Dense_0.bias", "MLP_0.Dense_1.bias"), 1e-6
LR = 1e-3
REG = {"embedding_l1": 1e-4, "embedding_l2": 1e-3, "dense_l1": 1e-5, "dense_l2": 1e-4}


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def labelled(n, seed):
    x = ctr_batch(n, seed=seed)
    return x, np.random.default_rng(seed + 100).integers(0, 2, n).astype(np.float32)


def first_update(g, p0, rule, wd):
    """The first step's update of a parameter from its gradient, in float64: Adam (weight decay
    in the gradient, m_hat = g, v_hat = g²), optax's scale_by_rss from 0.1, or the identity."""
    g, p0 = g.astype(np.float64), p0.astype(np.float64)
    if rule == "adagrad":
        return g / np.sqrt(0.1 + g * g + 1e-7)
    if rule == "sgd":
        return g
    g = g + wd * p0
    return g / (np.abs(g) + 1e-8)


def carried_trainers(tmp_path, optimizer_params=None, regularization_params=None):
    """A JAX CTRTrainer initialised on a batch, and the port's on its carried variables."""
    (js, jd), (ts, td) = schema(jfeat), schema(tfeat)
    jmodel = JDeepFM(deep_features=jd + js, fm_features=js, mlp_params=MLP_PARAMS)
    jtrainer = JCTRTrainer(jmodel, optimizer_params=optimizer_params, regularization_params=regularization_params, model_path=str(tmp_path / "jax"))
    x, y = labelled(8, seed=0)
    jtrainer._ensure_ready(jdata.ArrayLoader(x, y, batch_size=64))
    model = load_flax_params(DeepFM(td + ts, ts, MLP_PARAMS), np_tree(jtrainer.state.params), np_tree(jtrainer.state.batch_stats))
    trainer = CTRTrainer(model, optimizer_params=optimizer_params, regularization_params=regularization_params, model_path=str(tmp_path / "torch"), device="cpu")
    return jtrainer, trainer


@pytest.mark.parametrize("optimizer_params,reg", [(None, None), (None, REG), ({"lr": LR, "weight_decay": 1e-5, "embedding_optimizer": "adagrad"}, None), ({"lr": LR, "weight_decay": 1e-5, "embedding_optimizer": "sgd"}, REG)],
                         ids=["adam", "adam_regularized", "adagrad_tables", "sgd_tables_regularized"])
def test_train_step_matches_jax(tmp_path, optimizer_params, reg):
    """One step on a partial batch of 50 padded to 64 (cycled rows, weight 0), from carried weights."""
    jtrainer, trainer = carried_trainers(tmp_path, optimizer_params, reg)
    params0, stats0 = np_tree(jtrainer.state.params), np_tree(jtrainer.state.batch_stats)
    x, y = labelled(50, seed=1)

    # the JAX step's gradient: its trainer's loss on the same padded batch
    xp, yp, w = jdata.pad_batch(x, y, 64)
    jreg = JRegularizationLoss(**(reg or {}))

    def jloss(p):
        out, _ = jtrainer.model.apply({"params": p, "batch_stats": stats0}, {k: jnp.asarray(v) for k, v in xp.items()}, training=True, mutable=["batch_stats"])
        return jbce(out, jnp.asarray(yp), jnp.asarray(w)) + (jreg(p) if jreg else 0.0)

    ref_loss, jgrads = jax.value_and_grad(jloss)(params0)
    reg_grads = flax_to_state_dict(np_tree(jax.grad(jreg)(params0))) if jreg else {}
    jtrain_loss = jtrainer.train_one_epoch(jdata.ArrayLoader(x, y, batch_size=64), log_interval=0)
    loss = trainer.train_one_epoch(tdata.ArrayLoader(x, y, batch_size=64), log_interval=0)
    np.testing.assert_allclose(jtrain_loss, float(ref_loss), rtol=1e-6)  # the replica is the JAX step's loss
    np.testing.assert_allclose(loss, jtrain_loss, rtol=LOSS_RTOL, atol=LOSS_ATOL)

    grads, before, after = (flax_to_state_dict(t) for t in (np_tree(jgrads), params0, np_tree(jtrainer.state.params)))
    named = dict(trainer.model.named_parameters())
    assert set(named) == set(grads)
    emb_rule = (optimizer_params or {}).get("embedding_optimizer")
    floor = NOISE_REL * max(float(g.abs().max()) for g in grads.values())
    for name, p in named.items():
        g, r, p0 = p.grad.numpy(), grads[name].numpy(), before[name].numpy()
        if name in BN_INVARIANT:  # what is left of the gradient is the regularization's
            exact = reg_grads[name].numpy() if name in reg_grads else 0.0
            assert np.abs(g - exact).max() < floor and np.abs(r - exact).max() < floor, name
            grad_tol = floor
        else:
            grad_tol = GRAD_RTOL * np.abs(r) + GRAD_ATOL_REL * float(np.abs(r).max()) + 1e-12
            np.testing.assert_allclose(g, r, rtol=GRAD_RTOL, atol=GRAD_ATOL_REL * float(np.abs(r).max()) + 1e-12, err_msg=name)
        rule = emb_rule if emb_rule and name.endswith("_table") else "adam"
        u_ref = first_update(r, p0, rule, 1e-5)
        jitted = np.maximum(*(np.abs(first_update(r + s * grad_tol, p0, rule, 1e-5) - u_ref) for s in (-1, 1)))
        carried = LR * (np.abs(first_update(g, p0, rule, 1e-5) - u_ref) + jitted)
        got, ref = p.detach().numpy(), after[name].numpy()
        bad = np.abs(got - ref) > ADAM_UPDATE_TOL * LR + ADAM_RTOL * np.abs(ref) + carried
        assert not bad.any(), (name, got[bad][:4], ref[bad][:4], g[bad][:4], r[bad][:4], p0[bad][:4])
        assert not np.array_equal(got, p0) or not r.any(), name  # every parameter with a gradient moved
    ref_stats = flax_to_state_dict(np_tree(jtrainer.state.batch_stats))
    for name, b in trainer.model.named_buffers():
        np.testing.assert_allclose(b.numpy(), ref_stats[name].numpy(), rtol=STATS_RTOL, atol=STATS_ATOL, err_msg=name)


def test_table_optimizer_matches_optax_on_identical_grads():
    """Three steps of make_optimizer's split on the same gradients: optax's scale_by_rss (or
    the identity) for the tables, Adam with weight decay for the rest."""
    _, variables, model = carried_deepfm()
    params = variables["params"]
    for rule in ("adagrad", "sgd"):
        opt = {"lr": 3e-2, "weight_decay": 1e-2, "embedding_optimizer": rule}
        tx, jlr = jbase.make_optimizer(opt)
        optimizer, lr = tbase.make_optimizer(model.named_parameters(), opt)
        assert lr == jlr and isinstance(optimizer, tbase.SplitOptimizer)
        state, jparams = tx.init(params), params
        rng = np.random.default_rng(11)
        named = dict(model.named_parameters())
        for step in range(1, 4):
            grads = jax.tree_util.tree_map(lambda a: (rng.normal(size=a.shape) * (rng.uniform(size=a.shape) > 0.5)).astype(np.float32), jparams)
            updates, state = tx.update(grads, state, jparams)
            jparams = np_tree(jbase.apply_updates(jparams, updates, jlr))
            for name, g in flax_to_state_dict(grads).items():
                named[name].grad = g
            optimizer.step()
            for name, ref in flax_to_state_dict(jparams).items():
                np.testing.assert_allclose(named[name].detach().numpy(), ref.numpy(), rtol=ADAM_RTOL, atol=ADAM_UPDATE_TOL * lr * step, err_msg=f"{rule} {name}")
        model = load_flax_params(model, params, variables["batch_stats"])
    with pytest.raises(ValueError, match="embedding_optimizer"):
        tbase.make_optimizer(model.named_parameters(), {"embedding_optimizer": "adam"})
    with pytest.raises(ValueError, match="named_parameters"):
        tbase.make_optimizer(model.parameters(), {"embedding_optimizer": "sgd"})
    # torch.optim.Adagrad is another rule: eps outside the root, the sum from 0
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.full((3,), 0.5)
    tbase.TableOptimizer([p], lr=1.0).step()
    np.testing.assert_allclose(p.detach().numpy(), 1 - 0.5 / np.sqrt(0.1 + 0.25 + 1e-7), rtol=1e-6)


def test_adam_state_of_a_jax_deepfm_carries_into_the_port(tmp_path):
    """JAX takes two steps; its weights, BatchNorm statistics and Adam moments are carried into
    the port (flax's BatchNorm ``scale`` becomes ``weight``, the tables keep their names); both
    then apply the third update on the same gradients."""
    jtrainer, trainer = carried_trainers(tmp_path)
    x, y = labelled(128, seed=15)
    jtrainer.train_one_epoch(jdata.ArrayLoader(x, y, batch_size=64), log_interval=0)
    params = np_tree(jtrainer.state.params)
    (adam,) = [s for s in jax.tree_util.tree_leaves(jtrainer.state.opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")]
    assert int(adam.count) == 2
    model = load_flax_params(trainer.model, params, np_tree(jtrainer.state.batch_stats))
    load_optax_adam_state(trainer.optimizer, model, np_tree(adam.mu), np_tree(adam.nu), adam.count)
    rng = np.random.default_rng(16)
    grads = jax.tree_util.tree_map(lambda a: (rng.normal(size=a.shape) * 1e-3).astype(np.float32), params)
    updates, _ = jtrainer.tx.update(grads, jtrainer.state.opt_state, params)
    ref = flax_to_state_dict(np_tree(jbase.apply_updates(params, updates, jtrainer.lr0)))
    named = dict(model.named_parameters())
    for name, g in flax_to_state_dict(grads).items():
        named[name].grad = g
    trainer.optimizer.step()
    assert all(int(s["step"]) == 3 for s in trainer.optimizer.state.values())
    for name, r in ref.items():
        np.testing.assert_allclose(named[name].detach().numpy(), r.numpy(), rtol=ADAM_RTOL, atol=ADAM_UPDATE_TOL * LR * 3, err_msg=name)


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------

def test_loaders_match_jax():
    x, y = labelled(150, seed=2)
    for kw in ({"batch_size": 64}, {"batch_size": 64, "shuffle": True, "seed": 3}, {"batch_size": 40, "drop_last": True}):
        jl, tl = jdata.ArrayLoader(x, y, **kw), tdata.ArrayLoader(x, y, **kw)
        assert len(jl) == len(tl) and tl.dataset_size == 150
        for _ in range(2):  # two epochs: the shuffle advances the same way
            for (jx, jy), (tx, ty) in zip(jl, tl, strict=True):
                np.testing.assert_array_equal(ty, jy)
                assert all(np.array_equal(tx[k], jx[k]) for k in x)
    jfx, jfy = jdata.ArrayLoader(x, y, batch_size=64).first_batch()
    tfx, tfy = tdata.ArrayLoader(x, y, batch_size=64).first_batch()
    assert np.array_equal(tfy, jfy) and all(np.array_equal(tfx[k], jfx[k]) for k in x)
    for n in (64, 50, 3):
        part = {k: v[:n] for k, v in x.items()}
        (jx, jy, jw), (tx, ty, tw) = jdata.pad_batch(part, y[:n], 64), tdata.pad_batch(part, y[:n], 64)
        np.testing.assert_array_equal(tw, jw)
        np.testing.assert_array_equal(ty, jy)
        assert all(np.array_equal(tx[k], jx[k]) for k in x)
    assert tdata.pad_batch({"a": np.arange(3)}, None, 8)[0]["a"].tolist() == [0, 1, 2, 0, 1, 2, 0, 1]  # rows cycle

    jc = jdata.DeviceCachedLoader(x, y, batch_size=32, group_size=2, shuffle=True, seed=4)
    tc = tdata.DeviceCachedLoader(x, y, batch_size=32, group_size=2, shuffle=True, seed=4, device="cpu")
    assert len(tc) == len(jc) == 6 and tc.dataset_size == 150
    for _ in range(2):
        for (jxs, jys, jws), (txs, tys, tws) in zip(jc.device_groups(), tc.device_groups(), strict=True):
            assert tys.shape == (2, 32) and tws.dtype == torch.float32
            np.testing.assert_array_equal(tys.numpy(), np.asarray(jys))
            np.testing.assert_array_equal(tws.numpy(), np.asarray(jws))
            assert all(np.array_equal(txs[k].numpy(), np.asarray(jxs[k])) for k in x)
    for (jx, jy), (tx, ty) in zip(jc, tc, strict=True):
        np.testing.assert_array_equal(ty, jy)
    with pytest.raises(ValueError, match="inconsistent"):
        tdata.ArrayLoader({"a": np.zeros(3), "b": np.zeros(4)})
    with pytest.raises(ValueError, match="labels"):
        tdata.DeviceCachedLoader({"a": np.zeros(3)}, np.zeros(4), device="cpu")

    jg, tg = jdata.DataGenerator(x, y, seed=5), tdata.DataGenerator(x, y, seed=5)
    for jl, tl in zip(jg.generate_dataloader(split_ratio=[0.7, 0.15], batch_size=16), tg.generate_dataloader(split_ratio=[0.7, 0.15], batch_size=16), strict=True):
        assert jl.n == tl.n and np.array_equal(jl.y, tl.y) and tl.shuffle == jl.shuffle
    with pytest.raises(ValueError, match="inconsistent lengths"):
        tdata.DataGenerator({"a": np.zeros(3)}, np.zeros(4))


def test_steps_per_call_and_the_device_cached_loader_equal_single_steps(tmp_path):
    """256 rows, 64 a batch: every loader and grouping runs the same four steps, bit for bit."""
    x, y = labelled(256, seed=6)
    runs = {}
    for name, loader, spc in (("array", tdata.ArrayLoader(x, y, batch_size=64), 1), ("array spc 3", tdata.ArrayLoader(x, y, batch_size=64), 3),
                              ("cached", tdata.DeviceCachedLoader(x, y, batch_size=64, group_size=2, device="cpu"), 1)):
        _, _, model = carried_deepfm(mlp_params={**MLP_PARAMS, "dropout": 0.2})
        trainer = CTRTrainer(model, steps_per_call=spc, model_path=str(tmp_path), device="cpu")
        losses = [trainer.train_one_epoch(loader, log_interval=0) for _ in range(2)]
        runs[name] = (losses, {k: v.clone() for k, v in model.state_dict().items()})
    ref_losses, ref_state = runs.pop("array")
    assert np.isfinite(ref_losses).all()
    for name, (losses, state) in runs.items():
        assert losses == ref_losses, name
        assert all(torch.equal(v, ref_state[k]) for k, v in state.items()), name


# ---------------------------------------------------------------------------
# fit / evaluate / predict
# ---------------------------------------------------------------------------

def deepfm(dropout=0.2, seed=0):
    ts, td = schema(tfeat)
    return DeepFM(td, ts, {**MLP_PARAMS, "dropout": dropout}, generator=torch.Generator().manual_seed(seed))


def test_ranking_fit_evaluate_deepfm(tmp_path):
    """The DeepFM case of tests/test_e2e_ranking.py::test_ranking_fit_evaluate on the CPU."""
    x, y = synthetic_ctr_frame(n=300)
    train_dl, val_dl, test_dl = tdata.DataGenerator(x, y).generate_dataloader(split_ratio=[0.7, 0.15], batch_size=64)
    model = deepfm()
    trainer = CTRTrainer(model, n_epoch=1, model_path=str(tmp_path), device="cpu")
    trainer.fit(train_dl, val_dl)
    auc = trainer.evaluate(model, test_dl)
    assert 0.0 <= auc <= 1.0
    preds = trainer.predict(model, test_dl)
    assert preds.shape == (test_dl.dataset_size,) and preds.dtype == np.float32
    assert np.all((preds >= 0) & (preds <= 1))
    assert (tmp_path / "model.pt").is_file()


def test_predictions_invariant_to_batch_size(tmp_path):
    """tests/test_e2e_ranking.py::test_partial_batch_padding_consistency: 64 against 50 a batch."""
    x, y = synthetic_ctr_frame(n=100)
    model = deepfm()
    trainer = CTRTrainer(model, n_epoch=1, model_path=str(tmp_path), device="cpu")
    trainer.train_one_epoch(tdata.ArrayLoader(x, y, batch_size=64), log_interval=0)
    p1 = trainer.predict(model, tdata.ArrayLoader(x, y, batch_size=64))
    p2 = trainer.predict(model, tdata.ArrayLoader(x, batch_size=50))
    np.testing.assert_allclose(p1, p2, rtol=1e-4, atol=1e-5)


def test_fit_learns_a_learnable_task_and_logs(tmp_path):
    """Label from C0's parity and I0: three epochs bring the test AUC above 0.65; StepLR per epoch."""
    rng = np.random.default_rng(12)
    n = 3000
    x = {f"C{i}": rng.integers(0, VOCAB, n).astype(np.int32) for i in range(N_SPARSE)}
    x.update({f"I{i}": rng.normal(size=n).astype(np.float32) for i in range(3)})
    y = ((x["C0"] % 2) + x["I0"] > 0.5).astype(np.float32)
    train_dl, val_dl, test_dl = tdata.DataGenerator(x, y, seed=0).generate_dataloader(split_ratio=[0.7, 0.15], batch_size=128)
    logger = Recorder()
    trainer = CTRTrainer(deepfm(dropout=0.0), optimizer_params={"lr": 1e-2, "weight_decay": 1e-5}, scheduler_params={"step_size": 1, "gamma": 0.5}, n_epoch=3, model_path=str(tmp_path), model_logger=logger, device="cpu")
    trainer.fit(train_dl, val_dl)
    auc = trainer.evaluate(trainer.model, test_dl)
    assert auc > 0.65
    assert abs(trainer.evaluate(trainer.model, test_dl, bucketed=True) - auc) < 1e-4
    assert [m["learning_rate"] for _, m in logger.metrics if "learning_rate" in m] == [1e-2, 5e-3, 2.5e-3]
    assert logger.hparams == [{"n_epoch": 3, "learning_rate": 1e-2, "loss_mode": True}] and logger.finished


class Recorder(BaseLogger):
    def __init__(self):
        self.metrics, self.hparams, self.finished = [], [], False

    def log_metrics(self, metrics, step=None):
        self.metrics.append((step, dict(metrics)))

    def log_hyperparams(self, params):
        self.hparams.append(params)

    def finish(self):
        self.finished = True


def test_fit_stops_early_and_restores_the_best_weights_and_batch_stats(tmp_path, monkeypatch):
    x, y = labelled(128, seed=13)
    loader = tdata.ArrayLoader(x, y, batch_size=64)
    model = deepfm(dropout=0.0)
    trainer = CTRTrainer(model, n_epoch=10, earlystop_patience=2, model_path=str(tmp_path), device="cpu")
    aucs, snapshots = iter([0.6, 0.7, 0.65, 0.6, 0.9]), []

    def scripted_evaluate(model_, data_loader, bucketed=False):
        snapshots.append({k: v.clone() for k, v in model.state_dict().items()})
        return next(aucs)

    monkeypatch.setattr(trainer, "evaluate", scripted_evaluate)
    trainer.fit(loader, loader)
    assert len(snapshots) == 4  # epoch 1 was best; epochs 2 and 3 spent the patience
    best = snapshots[1]
    assert not torch.equal(best["MLP_0.BatchNorm_0.mean"], snapshots[3]["MLP_0.BatchNorm_0.mean"])
    for name, value in model.state_dict().items():
        assert torch.equal(value, best[name]), name
    saved = torch.load(tmp_path / "model.pt", weights_only=True)
    assert all(torch.equal(saved[k], best[k]) for k in best)
    with torch.no_grad():
        model.MLP_0.BatchNorm_0.var.zero_()
        model.EmbeddingCollection_0.C0_table.zero_()
    trainer.load()
    assert torch.equal(model.MLP_0.BatchNorm_0.var, best["MLP_0.BatchNorm_0.var"])
    assert torch.equal(model.EmbeddingCollection_0.C0_table, best["EmbeddingCollection_0.C0_table"])


def test_checkpoint_with_other_table_rows_names_the_table(tmp_path):
    """A table of 70,000 rows pads to 70,016: a checkpoint of unpadded rows raises, naming it."""
    feats = (tfeat.SparseFeature("big", 70_000, 4), tfeat.SparseFeature("small", 10, 4))
    model = DeepFM((tfeat.DenseFeature("d"),), feats, {"dims": (4,)}, generator=torch.Generator().manual_seed(0))
    trainer = CTRTrainer(model, model_path=str(tmp_path), device="cpu")
    state = {k: v.clone() for k, v in model.state_dict().items()}
    state["EmbeddingCollection_0.big_table"] = state["EmbeddingCollection_0.big_table"][:70_000]
    torch.save(state, tmp_path / "model.pt")
    with pytest.raises(ValueError, match=r"EmbeddingCollection_0\.big_table: checkpoint \(70000, 4\) vs model \(70016, 4\)"):
        trainer.load()
    trainer.save()
    trainer.load()


class WithAux(torch.nn.Module):
    """A model with ``loss_mode=False``: ``(logits, aux_loss)``."""

    def __init__(self):
        super().__init__()
        self.inner = deepfm(dropout=0.0)

    def forward(self, x, generator=None):
        logits = self.inner(x, generator=generator)
        return logits, 0.25 + 0.0 * logits.sum()


def test_loss_mode_false_adds_the_aux_loss(tmp_path):
    x, y = labelled(64, seed=14)
    aux = CTRTrainer(WithAux(), loss_mode=False, model_path=str(tmp_path), device="cpu")
    plain = CTRTrainer(deepfm(dropout=0.0), model_path=str(tmp_path), device="cpu")
    batch = [torch.from_numpy(a) for a in (y, np.ones(64, np.float32))]
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    np.testing.assert_allclose(float(aux.loss_fn(tx, *batch).detach()), float(plain.loss_fn(tx, *batch).detach()) + 0.25, rtol=1e-6)
    np.testing.assert_array_equal(aux.predict(aux.model, tdata.ArrayLoader(x, batch_size=64)), plain.predict(plain.model, tdata.ArrayLoader(x, batch_size=64)))


def test_unported_options_raise():
    model = deepfm()
    with pytest.raises(NotImplementedError, match="item 14"):
        CTRTrainer(model, device="cpu", mesh=object())
    # precision is ported (tests/test_torch_precision.py): bf16 is taken, an unknown name raises
    assert CTRTrainer(model, precision="bf16", device="cpu").precision == "bf16"
    with pytest.raises(ValueError, match="precision"):
        CTRTrainer(model, precision="fp8", device="cpu")
    # sparse_embedding is ported (tests/test_torch_sparse_train.py): an unknown method, or a model
    # without a fused table under the default "auto" layout, raises a ValueError
    for method, message in (("adam", "sparse_embedding must be"), ("adagrad", "set_fused_default")):
        with pytest.raises(ValueError, match=message):
            CTRTrainer(model, device="cpu", sparse_embedding=method)
    assert CTRTrainer(model, precision="f32", device="cpu").loss_mode
