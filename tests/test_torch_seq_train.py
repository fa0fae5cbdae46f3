"""The port's training path (``SeqTrainer`` steps, losses, Adam, StepLR,
early stopping) against the JAX package on carried weights.

Gradients are compared on one batch; the optimizer is compared on identical
gradients, not after steps on each framework's own gradients (Adam's first
step is about ``lr * sign(g)``, so rounding noise in a near-zero gradient
would move a parameter by ``2 * lr``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_seq_eval import MODEL_KW, VOCAB, seq_data
from torch_rechub_tpu.models.generative.hstu import HSTUModel as JHSTUModel
from torch_rechub_tpu.ops import chunked_ce as jce
from torch_rechub_tpu.trainers import base as jbase
from torch_rechub_tpu.trainers.seq_trainer import SeqTrainer as JSeqTrainer
from torch_rechub_tpu.trainers.seq_trainer import next_token_loss as jnext_token_loss
from torch_rechub_tpu.utils.data import SeqLoader as JSeqLoader
from torch_rechub_tpu_torch.basic.callback import EarlyStopper
from torch_rechub_tpu_torch.basic.tracking import BaseLogger
from torch_rechub_tpu_torch.models.generative.hstu import HSTUModel
from torch_rechub_tpu_torch.ops import chunked_ce as tce
from torch_rechub_tpu_torch.trainers import base as tbase
from torch_rechub_tpu_torch.trainers.seq_trainer import SeqTrainer
from torch_rechub_tpu_torch.utils.data import SeqLoader
from torch_rechub_tpu_torch.utils.jax_weights import flax_to_state_dict, load_flax_params, load_optax_adam_state

# One batch's loss: the tolerance of the serving losses (test_torch_seq_eval.py).
LOSS_RTOL, LOSS_ATOL = 2e-5, 1e-5
# Gradients through two layers and the output projection: the layers'
# forward tolerance (2e-4 relative, test_torch_hstu_model.py), and an
# absolute floor of 1e-4 of each tensor's largest gradient for elements that
# are sums of many terms cancelling to near zero.
GRAD_RTOL, GRAD_ATOL_REL = 2e-4, 1e-4
# Adam on identical gradients: optax takes the bias correction 1 - b2**t in
# f32, torch in float64.  With b2 = 0.999 the f32 difference cancels to a
# relative error of up to 3e-5 (t = 2), 1.5e-5 after its square root; so an
# update may differ by 3e-5 of lr, summed over the steps.
ADAM_RTOL, ADAM_UPDATE_TOL = 1e-6, 3e-5
SAMPLED_KW = dict(tie_embeddings=False, score_norm="l2", temperature=0.5)


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def carried_model(seed=0, **kw):
    toks, _, _, tds = seq_data(n=8)
    jmodel = JHSTUModel(**MODEL_KW, **kw)
    params = np_tree(jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(toks), jnp.asarray(tds), training=False)["params"])
    return jmodel, params, load_flax_params(HSTUModel(**MODEL_KW, **kw), params)


def assert_grads_match(model, jgrads):
    ref = flax_to_state_dict(np_tree(jgrads))
    named = dict(model.named_parameters())
    assert set(named) == set(ref)
    for name, p in named.items():
        r = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=GRAD_RTOL, atol=GRAD_ATOL_REL * float(np.abs(r).max()) + 1e-12, err_msg=name)


# ---------------------------------------------------------------------------
# one batch: loss and every parameter's gradient against jax.value_and_grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loss_type,chunk", [("cross_entropy", None), ("cross_entropy", 16), ("nce", None), ("nce", 16)], ids=["dense", "chunked", "nce", "nce_chunked"])
def test_train_loss_and_grads_match_jax(loss_type, chunk):
    jmodel, params, model = carried_model(seed=1)
    toks, _, tgts, tds = seq_data(n=8, seed=2)
    trainer = SeqTrainer(model, loss_type=loss_type, vocab_chunk_size=chunk, device="cpu")
    temperature = trainer.temperature

    def jloss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(toks), jnp.asarray(tds), training=True, return_hidden=chunk is not None, rngs={"dropout": jax.random.PRNGKey(0)})
        if chunk is None:
            return jnext_token_loss(out, jnp.asarray(toks), jnp.asarray(tgts), temperature, 0)
        return jce.chunked_next_token_loss(out["hidden"], out["weight"], jnp.asarray(toks), jnp.asarray(tgts), out["bias"], trainer.chunked_t, 0, chunk)

    ref_loss, jgrads = jax.value_and_grad(jloss)(params)
    model.train()
    loss = trainer.loss_fn(*(torch.from_numpy(a) for a in (toks, tds, tgts)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert_grads_match(model, jgrads)


def full_sequences(n, seed):
    """Sequences without PAD (see test_l2_score_norm_diverges_from_jax_on_padded_sequences)."""
    toks, pos, tgts, tds = seq_data(n=n, seed=seed)
    return np.random.default_rng(seed).integers(1, VOCAB, toks.shape).astype(np.int32), pos, tgts, tds


def test_sampled_softmax_loss_and_grads_match_jax_on_injected_ids(monkeypatch):
    """The two packages draw negatives from different RNGs, so the test hands
    both the same candidate ids through ``sampled_loss_from_rows``."""
    jmodel, params, model = carried_model(seed=3, **SAMPLED_KW)
    toks, _, tgts, tds = full_sequences(8, seed=4)
    negs = np.random.default_rng(5).integers(1, VOCAB, 24)
    negs[:3] = tgts[:3]  # accidental hits, masked out of the loss
    trainer = SeqTrainer(model, loss_type="sampled_softmax", loss_params={"num_negatives": 24}, device="cpu")
    monkeypatch.setattr(tce, "sampled_candidates", lambda seq_tokens, targets, gen, v, s, ignore: (tce.shifted_labels(seq_tokens, targets, ignore), torch.from_numpy(negs)))

    def jloss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(toks), jnp.asarray(tds), training=True, return_hidden=True)
        next_tokens, _ = jce.sampled_candidates(jnp.asarray(toks), jnp.asarray(tgts), jax.random.PRNGKey(0), VOCAB, 24, 0)
        w, b, jn = out["weight"], out["bias"], jnp.asarray(negs)
        return jce.sampled_loss_from_rows(out["hidden"], w[next_tokens], w[jn], b[next_tokens], b[jn], next_tokens, jn, VOCAB, trainer.sampled_t, 0, True, True)

    ref_loss, jgrads = jax.value_and_grad(jloss)(params)
    model.train()
    loss = trainer.loss_fn(*(torch.from_numpy(a) for a in (toks, tds, tgts)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert_grads_match(model, jgrads)


def test_l2_score_norm_diverges_from_jax_on_padded_sequences():
    """A known divergence: PAD positions have zero hidden states, and the
    gradient of ``jnp.linalg.norm`` at zero is NaN, so the JAX package's
    gradients under ``score_norm="l2"`` are NaN for any batch with PAD.
    torch's norm has a zero subgradient there: the port's gradients are
    finite and the PAD positions contribute nothing."""
    jmodel, params, model = carried_model(seed=3, **SAMPLED_KW)
    toks, _, tgts, tds = seq_data(n=8, seed=4)
    assert (toks == 0).any()
    trainer = SeqTrainer(model, loss_type="sampled_softmax", loss_params={"num_negatives": 24}, device="cpu")

    def jloss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(toks), jnp.asarray(tds), training=True, return_hidden=True)
        return jce.chunked_next_token_loss(out["hidden"], out["weight"], jnp.asarray(toks), jnp.asarray(tgts), out["bias"], trainer.sampled_t, 0, 16)

    jgrads = jax.grad(jloss)(params)
    assert np.isnan(np.asarray(jgrads["token_embedding"])).any()
    model.train()
    trainer.loss_fn(*(torch.from_numpy(a) for a in (toks, tds, tgts))).backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


def test_sampled_next_token_loss_draws_from_the_generator():
    rng = np.random.default_rng(6)
    hidden, weight = (torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((2, 5, 8), (VOCAB, 8)))
    toks = torch.from_numpy(rng.integers(0, VOCAB, (2, 5)))
    tgts = torch.from_numpy(rng.integers(1, VOCAB, 2))
    losses = [float(tce.sampled_next_token_loss(hidden, weight, toks, tgts, torch.Generator().manual_seed(s), num_negatives=16)) for s in (0, 0, 1)]
    assert losses[0] == losses[1] != losses[2] and np.isfinite(losses).all()
    _, negs = tce.sampled_candidates(toks, tgts, torch.Generator().manual_seed(0), VOCAB, 4096, ignore_index=0)
    assert int(negs.min()) >= 1 and int(negs.max()) <= VOCAB - 1  # uniform over the vocab without PAD


# ---------------------------------------------------------------------------
# the optimizer and the schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt", [None, {"lr": 3e-3, "weight_decay": 1e-2, "betas": (0.8, 0.95)}], ids=["default", "wd_betas"])
def test_adam_matches_jax_make_optimizer_on_identical_grads(opt):
    _, params, model = carried_model(seed=7)
    tx, jlr = jbase.make_optimizer(opt)
    optimizer, lr = tbase.make_optimizer(model.parameters(), opt)
    assert lr == jlr
    state = tx.init(params)
    rng = np.random.default_rng(8)
    named = dict(model.named_parameters())
    for step in range(1, 4):
        grads = jax.tree_util.tree_map(lambda a: (rng.normal(size=a.shape) * 10.0 ** rng.integers(-6, 0)).astype(np.float32), params)
        updates, state = tx.update(grads, state, params)
        params = np_tree(jbase.apply_updates(params, updates, jlr))
        for name, g in flax_to_state_dict(grads).items():
            named[name].grad = g
        optimizer.step()
        for name, ref in flax_to_state_dict(params).items():
            np.testing.assert_allclose(named[name].detach().numpy(), ref.numpy(), rtol=ADAM_RTOL, atol=ADAM_UPDATE_TOL * lr * step, err_msg=name)
    with pytest.raises(NotImplementedError, match="embedding_optimizer"):
        tbase.make_optimizer(model.parameters(), {"embedding_optimizer": "adagrad"})


class Recorder(BaseLogger):
    def __init__(self):
        self.metrics, self.hparams, self.finished = [], [], False

    def log_metrics(self, metrics, step=None):
        self.metrics.append((step, dict(metrics)))

    def log_hyperparams(self, params):
        self.hparams.append(params)

    def finish(self):
        self.finished = True


def test_step_lr_per_epoch_matches_jax(tmp_path):
    sched = {"step_size": 2, "gamma": 0.5}
    for epoch in range(6):
        assert tbase.step_lr(2e-3, epoch, sched) == jbase.step_lr(2e-3, epoch, sched)
    assert tbase.step_lr(2e-3, 5, None) == 2e-3
    _, _, model = carried_model(seed=9)
    toks, pos, tgts, tds = seq_data(n=8)
    logger = Recorder()
    trainer = SeqTrainer(model, optimizer_params={"lr": 2e-3}, scheduler_params=sched, n_epoch=5, model_path=str(tmp_path), model_logger=logger, device="cpu")
    trainer.fit(SeqLoader(toks, pos, tgts, tds, batch_size=4))
    assert [m["learning_rate"] for _, m in logger.metrics] == [2e-3 * 0.5 ** (e // 2) for e in range(5)]
    assert [g["lr"] for g in trainer.optimizer.param_groups] == [2e-3 * 0.25]
    assert logger.hparams == [{"n_epoch": 5, "learning_rate": 2e-3, "loss_type": "cross_entropy"}] and logger.finished


def test_one_step_after_carrying_jax_adam_state(tmp_path):
    """JAX takes two steps; its weights and Adam state are carried into the
    port; both take the third step on the same batch."""
    toks, pos, tgts, tds = seq_data(n=24, seed=10)
    jtrainer = JSeqTrainer(JHSTUModel(**MODEL_KW), n_epoch=1, model_path=str(tmp_path))
    jtrainer.train_one_epoch(JSeqLoader(toks[:16], pos[:16], tgts[:16], tds[:16], batch_size=8), log_interval=0)
    params = np_tree(jtrainer.state.params)
    (adam,) = [s for s in jax.tree_util.tree_leaves(jtrainer.state.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")]
    assert int(adam.count) == 2
    model = load_flax_params(HSTUModel(**MODEL_KW), params)
    trainer = SeqTrainer(model, device="cpu")
    load_optax_adam_state(trainer.optimizer, model, np_tree(adam.mu), np_tree(adam.nu), adam.count)
    third = (toks[16:], pos[16:], tgts[16:], tds[16:])
    jtrainer.train_one_epoch(JSeqLoader(*third, batch_size=8), log_interval=0)
    trainer.train_one_epoch(SeqLoader(*third, batch_size=8), log_interval=0)
    assert all(int(s["step"]) == 3 for s in trainer.optimizer.state.values())
    # each update is lr * mu_hat / (sqrt(nu_hat) + eps) from carried moments
    # plus one new gradient 2e-4 apart: far below lr = 1e-3
    for name, ref in flax_to_state_dict(np_tree(jtrainer.state.params)).items():
        np.testing.assert_allclose(dict(model.named_parameters())[name].detach().numpy(), ref.numpy(), rtol=1e-5, atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# the epoch loop: steps_per_call, early stopping, checkpoints, options
# ---------------------------------------------------------------------------

def test_steps_per_call_equals_single_steps(tmp_path):
    toks, pos, tgts, tds = seq_data(n=36, seed=11)  # 4 full batches of 8 and a tail of 4
    results = []
    for spc in (1, 4):
        model = HSTUModel(**{**MODEL_KW, "dropout": 0.2}, generator=torch.Generator().manual_seed(0))
        trainer = SeqTrainer(model, steps_per_call=spc, seed=3, device="cpu")
        losses = [trainer.train_one_epoch(SeqLoader(toks, pos, tgts, tds, batch_size=8), log_interval=0) for _ in range(2)]
        results.append((losses, {k: v.clone() for k, v in model.state_dict().items()}))
    assert results[0][0] == results[1][0] and np.isfinite(results[0][0]).all()
    for name, a in results[0][1].items():
        assert torch.equal(a, results[1][1][name]), name


def test_dropout_draws_from_the_trainers_generator():
    toks, _, tgts, tds = seq_data(n=8, seed=12)
    batch = [torch.from_numpy(a) for a in (toks, tds, tgts)]

    trainers = [SeqTrainer(HSTUModel(**{**MODEL_KW, "dropout": 0.3}, generator=torch.Generator().manual_seed(0)), seed=seed, device="cpu") for seed in (0, 0, 1)]
    global_state = torch.random.get_rng_state()
    a, b, c = (float(t.train_step(*batch)) for t in trainers)
    assert torch.equal(torch.random.get_rng_state(), global_state)  # the steps drew nothing from torch's global RNG
    assert a == b != c


def test_early_stopper_keeps_the_best_weights():
    stopper = EarlyStopper(patience=2)
    assert not stopper.stop_training(0.3, "w0")
    assert not stopper.stop_training(0.5, "w1")
    assert not stopper.stop_training(0.4, "w2")
    assert stopper.stop_training(0.5, "w3")  # not an improvement: patience spent
    assert (stopper.best_auc, stopper.best_weights) == (0.5, "w1")


def test_fit_stops_early_and_restores_the_best_weights(tmp_path, monkeypatch):
    _, _, model = carried_model(seed=13)
    toks, pos, tgts, tds = seq_data(n=16, seed=14)
    loader = SeqLoader(toks, pos, tgts, tds, batch_size=8)
    trainer = SeqTrainer(model, n_epoch=10, earlystop_patience=2, model_path=str(tmp_path), device="cpu")
    accuracies, snapshots = iter([0.2, 0.6, 0.5, 0.4, 0.9]), []

    def scripted_evaluate(data_loader):
        snapshots.append({k: v.clone() for k, v in model.state_dict().items()})
        return 1.0, next(accuracies)

    monkeypatch.setattr(trainer, "evaluate", scripted_evaluate)
    trainer.fit(loader, loader)
    assert len(snapshots) == 4  # epoch 1 was best; epochs 2 and 3 spent the patience
    best = snapshots[1]
    assert not torch.equal(best["token_embedding"], snapshots[3]["token_embedding"])
    for name, value in model.state_dict().items():
        assert torch.equal(value, best[name]), name
    # the checkpoint holds the restored weights and loads back
    saved = torch.load(tmp_path / "model.pt", weights_only=True)
    assert all(torch.equal(saved[k], best[k]) for k in best)
    with torch.no_grad():
        model.token_embedding.zero_()
    trainer.load()
    assert torch.equal(model.token_embedding, best["token_embedding"])


def test_fit_trains_a_learnable_sequence_task(tmp_path):
    """Successor sequences (next token = token + 1): a few epochs of Adam on
    the CPU bring the held-out top-1 well above chance."""
    rng = np.random.default_rng(15)
    starts = rng.integers(1, VOCAB - 16, 64)
    seqs = (starts[:, None] + np.arange(16)[None, :]).astype(np.int32)
    toks, tgts = seqs, (seqs[:, -1] + 1).astype(np.int32)
    tds = np.tile(np.arange(16, dtype=np.int32) * 60, (64, 1))
    pos = np.tile(np.arange(16, dtype=np.int32), (64, 1))
    model = HSTUModel(**MODEL_KW, generator=torch.Generator().manual_seed(0))
    trainer = SeqTrainer(model, optimizer_params={"lr": 1e-2, "weight_decay": 0.0}, n_epoch=8, model_path=str(tmp_path), vocab_chunk_size=16, device="cpu")
    loader = SeqLoader(toks, pos, tgts, tds, batch_size=16, shuffle=True)
    _, before = trainer.evaluate(loader)
    trainer.fit(loader, loader)
    _, after = trainer.evaluate(loader)
    assert after >= 0.5 > before + 0.2


def test_sparse_embedding_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="sparse"):
        SeqTrainer(HSTUModel(**MODEL_KW), sparse_embedding="adagrad", device="cpu")
