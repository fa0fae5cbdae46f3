"""One ``MatchTrainer`` step of the port against the JAX package's
``MatchTrainer`` from the same weights and Adam, at the sizes of
``tests/test_e2e_matching.py`` with dropout 0: each mode (0 point-wise BCE
with regularization, 1 BPR on a pair and on SASRec's positions, 2 the
list-wise CE, MIND with its routing start given to both sides), the
in-batch hard negatives under the CE and under BPR, and the sparse row-wise
updates (SGD on the list-wise path, Adagrad on the in-batch path, where the
gather hooks record inside ``towers``), every table fused.  Each step is
held to the JAX step's loss (rtol 2e-5, atol 1e-5), gradients (rtol 2e-4,
atol 1e-4 of the largest), every parameter after Adam
(``test_torch_cuda_ranking.check_step``), and for the sparse steps the
table (rtol 1e-5, atol 1e-6), its step and the accumulators.

Then what the JAX package's random streams do not let a parity test pin:
the uniform in-batch sampler's properties, and the port's mirrors of
``tests/test_e2e_matching.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from test_torch_ctr_model import np_tree
from test_torch_ctr_train import REG
from test_torch_cuda_matching import BATCH, D, LOSS_ATOL, LOSS_RTOL, N_ITEMS, N_USERS, OUT_ATOL, OUT_RTOL, SEQ_LEN, build_match, given_routing_start, labels, match_frame, mode_of
from test_torch_cuda_ranking import LR, WD, check_step
from test_torch_cuda_sparse import step_ratio
from test_torch_match_models import jax_batch, jax_routing, redrawn
from test_torch_sparse_train import TABLE_ATOL, TABLE_RTOL
from torch_rechub_tpu.basic import features as jfeat
from torch_rechub_tpu.models import matching as jmatching
from torch_rechub_tpu.ops import embedding as jemb
from torch_rechub_tpu.trainers.match_trainer import MatchTrainer as JMatchTrainer
from torch_rechub_tpu.utils import data as jdata
from torch_rechub_tpu_torch.basic import features as tfeat
from torch_rechub_tpu_torch.basic.features import SequenceFeature, SparseFeature
from torch_rechub_tpu_torch.models import matching as tmatching
from torch_rechub_tpu_torch.ops import embedding as temb
from torch_rechub_tpu_torch.trainers import MatchTrainer
from torch_rechub_tpu_torch.utils import data as tdata
from torch_rechub_tpu_torch.utils.data import ArrayLoader, MatchDataGenerator
from torch_rechub_tpu_torch.utils.jax_weights import flax_to_state_dict, load_flax_params
from torch_rechub_tpu_torch.utils.match import gather_inbatch_logits, gen_model_input, generate_seq_feature_match, inbatch_negative_sampling

OPT = {"lr": LR, "weight_decay": WD}
STEP_CASES = {
    "DSSM": dict(mode=0, regularization_params=REG),
    "FaceBookDSSM": dict(mode=1),
    "YoutubeDNN": dict(mode=2),
    "SASRec": dict(mode=1),
    "MIND": dict(mode=2),
    "DSSM:in_batch_hard": dict(mode=2, in_batch_neg=True, hard_negative=True, in_batch_neg_ratio=4),
    "YoutubeDNN:in_batch_hard_bpr": dict(mode=1, in_batch_neg=True, hard_negative=True, in_batch_neg_ratio=4),
}
SPARSE_CASES = {"sgd": ("YoutubeDNN", dict(mode=2)), "adagrad": ("DSSM", dict(mode=0, in_batch_neg=True, hard_negative=True, in_batch_neg_ratio=4))}


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def all_fused():
    old = (jemb.set_fused_default(True), temb.set_fused_default(True))
    yield
    jemb.set_fused_default(old[0])
    temb.set_fused_default(old[1])


def step_pair(tmp_path, monkeypatch, name, kw, sparse=None):
    """A JAX MatchTrainer and the port's from the same redrawn weights, the JAX gradients of the padded
    batch, and both trainers after one step on 50 rows padded to 64."""
    start = given_routing_start(monkeypatch, seed=9)
    jax_routing(monkeypatch, start.numpy())
    model_name = name.partition(":")[0]
    jtrainer, trainer, variables, x, y = carried_pair(tmp_path, model_name, kw, sparse)
    y = labels(model_name, x, y)

    xp, yp, w = jdata.pad_batch(x, y, BATCH)
    key = jax.random.PRNGKey(0)

    def jloss(p):
        def apply_fn(batch, rng, method=None):
            return jtrainer.model.apply({"params": p, "batch_stats": variables["batch_stats"]}, batch, training=True, rngs={"dropout": rng, "routing": rng}, mutable=["batch_stats"], method=method)

        loss, _ = jtrainer._mode_loss(apply_fn, jax_batch(xp), jnp.asarray(yp), jnp.asarray(w), key, key)
        return loss + (jtrainer.reg_loss_fn(p) if jtrainer.reg_loss_fn else 0.0)

    ref_loss, jgrads = jax.jit(jax.value_and_grad(jloss))(variables["params"])
    jstep_loss = jtrainer.train_one_epoch(jdata.ArrayLoader(x, y, batch_size=BATCH), log_interval=0)
    loss = trainer.train_one_epoch(tdata.ArrayLoader(x, y, batch_size=BATCH), log_interval=0)
    np.testing.assert_allclose(jstep_loss, float(ref_loss), rtol=1e-6)
    np.testing.assert_allclose(loss, jstep_loss, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    ref_grads, before, after = (flax_to_state_dict(t) for t in (np_tree(jgrads), variables["params"], np_tree(jtrainer.state.params)))
    return jtrainer, trainer, ref_grads, before, after


@pytest.mark.parametrize("name", STEP_CASES)
def test_match_train_step_matches_jax(tmp_path, monkeypatch, name):
    _, trainer, ref_grads, before, after = step_pair(tmp_path, monkeypatch, name, STEP_CASES[name])
    named = dict(trainer.model.named_parameters())
    check_step({k: p.grad.numpy() for k, p in named.items()}, {k: p.detach().numpy() for k, p in named.items()},
               {k: v.numpy() for k, v in ref_grads.items()}, {k: v.numpy() for k, v in after.items()}, {k: v.numpy() for k, v in before.items()}, BATCH, ref_grad_noise=True)


@pytest.mark.parametrize("method", SPARSE_CASES)
def test_sparse_match_train_step_matches_jax(tmp_path, monkeypatch, all_fused, method):
    """One sparse step, every table fused into ``embedding.fused_d8_table``: the dense parameters after Adam,
    the table and its step, the accumulators; the rows no id of the batch reads stay as they were."""
    name, kw = SPARSE_CASES[method]
    jtrainer, trainer, ref_grads, before, after = step_pair(tmp_path, monkeypatch, name, kw, sparse=method)
    (table_name,) = trainer.sparse_tables
    assert table_name == "embedding.fused_d8_table"
    table = trainer.sparse_tables[table_name]
    assert table.grad is None
    rest = {k: p for k, p in trainer.model.named_parameters() if k != table_name}
    check_step({k: p.grad.numpy() for k, p in rest.items()}, {k: p.detach().numpy() for k, p in rest.items()},
               {k: ref_grads[k].numpy() for k in rest}, {k: after[k].numpy() for k in rest}, {k: before[k].numpy() for k in rest}, BATCH, ref_grad_noise=True)
    np.testing.assert_allclose(table.detach().numpy(), after[table_name].numpy(), rtol=TABLE_RTOL, atol=TABLE_ATOL)
    t0 = before[table_name]
    assert step_ratio(table, t0, after[table_name].double() - t0.double(), 2e-4 if method == "sgd" else 4e-4, 1e-4) <= 1.0
    jaccum = flax_to_state_dict(np_tree(jtrainer.state.opt_state[1]))[table_name].numpy()
    np.testing.assert_allclose(trainer.sparse_accums[table_name].numpy(), jaccum, rtol=TABLE_RTOL, atol=TABLE_ATOL * max(float(jaccum.max()), 1e-12))
    touched = np.abs(ref_grads[table_name].numpy()).max(axis=1) > 0
    assert touched.any()
    np.testing.assert_array_equal(table.detach().numpy()[~touched], t0.numpy()[~touched])


def test_uniform_inbatch_sampling_properties():
    """Uniform draws cannot match JAX's bit for bit: no row samples itself, a row's columns are distinct, and
    ``neg_ratio`` is clamped to B − 1 (``None``, 0 and more than B − 1 all take B − 1)."""
    scores = torch.randn(9, 9)
    g = torch.Generator().manual_seed(0)
    for ratio, k in ((3, 3), (8, 8), (None, 8), (0, 8), (20, 8)):
        for _ in range(5):
            idx = inbatch_negative_sampling(scores, neg_ratio=ratio, generator=g)
            assert idx.shape == (9, k)
            assert not (idx == torch.arange(9)[:, None]).any()
            assert all(len(set(row.tolist())) == k for row in idx)
    first = inbatch_negative_sampling(scores, 4, generator=torch.Generator().manual_seed(1))
    assert torch.equal(first, inbatch_negative_sampling(scores, 4, generator=torch.Generator().manual_seed(1)))
    assert not torch.equal(first, inbatch_negative_sampling(scores, 4, generator=torch.Generator().manual_seed(2)))
    with pytest.raises(ValueError):
        inbatch_negative_sampling(torch.zeros(1, 1))


def test_match_trainer_rejects_what_is_not_ported(tmp_path):
    model = build_match(tmatching, tfeat, "DSSM")
    with pytest.raises(ValueError, match="mode"):
        MatchTrainer(model, mode=3, device="cpu")
    with pytest.raises(ValueError, match="neg_pool"):
        MatchTrainer(model, neg_pool="shard", device="cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
        MatchTrainer(model, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="precision"):  # bf16 is ported (tests/test_torch_precision.py)
        MatchTrainer(model, precision="fp8", device="cpu")
    assert MatchTrainer(model, precision="bf16", device="cpu").precision == "bf16"
    assert MatchTrainer(model, neg_pool="local", device="cpu").neg_pool == "local"  # no mesh: the whole batch either way


# ---------------------------------------------------------------------------
# the port's mirrors of tests/test_e2e_matching.py: real preprocessing -> fit -> inference_embedding
# ---------------------------------------------------------------------------

def make_interactions(n=400, seed=0):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"user_id": rng.integers(1, N_USERS, n), "item_id": rng.integers(1, N_ITEMS, n), "time": rng.integers(0, 10000, n)})


def prepare(mode, neg_ratio=2):
    df_train, df_test = generate_seq_feature_match(make_interactions(), "user_id", "item_id", "time", mode=mode, neg_ratio=neg_ratio)
    user_profile, item_profile = pd.DataFrame({"user_id": np.arange(N_USERS)}), pd.DataFrame({"item_id": np.arange(N_ITEMS)})
    x_train = gen_model_input(df_train, user_profile, "user_id", item_profile, "item_id", seq_max_len=SEQ_LEN)
    if mode == 0:
        y = x_train.pop("label")
    else:
        y = np.zeros(len(x_train["user_id"]), dtype=np.int64)
        x_train.pop("label", None)
    return x_train, np.asarray(y), gen_model_input(df_test, user_profile, "user_id", item_profile, "item_id", seq_max_len=SEQ_LEN)


def user_item_features(n_neg=0):
    user = (SparseFeature("user_id", vocab_size=N_USERS, embed_dim=D), SequenceFeature("hist_item_id", vocab_size=N_ITEMS, embed_dim=D, pooling="mean", shared_with="item_id"))
    item = (SparseFeature("item_id", vocab_size=N_ITEMS, embed_dim=D),)
    neg = (SequenceFeature("neg_items", vocab_size=N_ITEMS, embed_dim=D, pooling="concat", shared_with="item_id"),) if n_neg else ()
    return user, item, neg


def test_e2e_dssm_pointwise_and_inference(tmp_path):
    x_train, y, x_test = prepare(mode=0)
    user, item, _ = user_item_features()
    model = tmatching.DSSM(user_features=user, item_features=item, user_params={"dims": (16, D)}, item_params={"dims": (16, D)})
    train_dl, test_dl, item_dl = MatchDataGenerator(x_train, y).generate_dataloader(x_test, {"item_id": np.arange(N_ITEMS)}, batch_size=64)
    trainer = MatchTrainer(model, mode=0, n_epoch=1, model_path=str(tmp_path), device="cpu")
    trainer.fit(train_dl)
    assert os.path.exists(tmp_path / "model.pt")
    user_emb = trainer.inference_embedding(model, "user", test_dl, str(tmp_path))
    item_emb = trainer.inference_embedding(model, "item", item_dl, str(tmp_path))
    assert user_emb.shape == (len(x_test["user_id"]), D) and item_emb.shape == (N_ITEMS, D)
    np.testing.assert_allclose(np.linalg.norm(user_emb, axis=1), 1.0, rtol=1e-4)


@pytest.mark.parametrize("name", ["DSSMSENet", "FaceBookDSSM", "YoutubeDNN", "GRU4Rec", "MIND", "ComirecSA", "ComirecDR", "YoutubeSBC"])
def test_e2e_models_fit(tmp_path, name):
    """Each class of the e2e tests fits one epoch on preprocessed data; the multi-interest models embed
    users as ``(B, K, D)``."""
    mode = {"DSSMSENet": 0, "FaceBookDSSM": 1}.get(name, 2)
    x_train, y, _ = prepare(mode=mode, neg_ratio=1 if name == "YoutubeSBC" else 3 if mode == 2 else 2)
    user, item, neg = user_item_features(n_neg=3)
    hist = (SequenceFeature("hist_item_id", vocab_size=N_ITEMS, embed_dim=D, pooling="concat", shared_with="item_id"),)
    mlp = {"dims": (16, D)}
    if name == "DSSMSENet":
        model = tmatching.DSSMSENet(user_features=user, item_features=item, user_params=mlp, item_params=mlp)
    elif name == "FaceBookDSSM":
        model = tmatching.FaceBookDSSM(user_features=user, pos_item_features=item, neg_item_features=(SparseFeature("neg_items", vocab_size=N_ITEMS, embed_dim=D, shared_with="item_id"),), user_params=mlp, item_params=mlp)
    elif name == "YoutubeDNN":
        model = tmatching.YoutubeDNN(user_features=user, item_features=item, neg_item_feature=neg, user_params=mlp)
    elif name == "GRU4Rec":
        model = tmatching.GRU4Rec(user_features=user[:1], history_features=hist, item_features=item, neg_item_feature=neg, user_params={**mlp, "num_layers": 1})
    elif name == "MIND":
        model = tmatching.MIND(user_features=user[:1], history_features=hist, item_features=item, neg_item_feature=neg, max_length=SEQ_LEN)
    elif name == "ComirecSA":
        model = tmatching.ComirecSA(user_features=user[:1], history_features=hist, item_features=item, neg_item_feature=neg)
    elif name == "ComirecDR":
        model = tmatching.ComirecDR(user_features=user[:1], history_features=hist, item_features=item, neg_item_feature=neg, max_length=SEQ_LEN)
    else:
        x_train["sample_weight"] = np.ones(len(x_train["user_id"]), dtype=np.float32)
        model = tmatching.YoutubeSBC(user_features=user, item_features=item, sample_weight_feature=(tfeat.DenseFeature("sample_weight"),), user_params=mlp, item_params=mlp, batch_size=64, n_neg=3)
    trainer = MatchTrainer(model, mode=mode, n_epoch=1, model_path=str(tmp_path), device="cpu")
    trainer.fit(ArrayLoader(x_train, y, batch_size=64, shuffle=True))
    loader = ArrayLoader({k: v for k, v in x_train.items() if not k.startswith("neg")}, batch_size=64)
    emb = trainer.inference_embedding(model, "user", loader, str(tmp_path))
    assert emb.shape[0] == len(x_train["user_id"]) and emb.ndim == (3 if name in ("MIND", "ComirecSA", "ComirecDR") else 2)
    assert np.isfinite(emb).all()


def test_e2e_dssm_inbatch_negatives(tmp_path):
    x_train, y, _ = prepare(mode=0)
    keep = y == 1
    x_pos = {k: v[keep] for k, v in x_train.items()}
    user, item, _ = user_item_features()
    model = tmatching.DSSM(user_features=user, item_features=item, user_params={"dims": (16, D)}, item_params={"dims": (16, D)})
    for hard in (False, True):
        trainer = MatchTrainer(model, mode=0, in_batch_neg=True, in_batch_neg_ratio=4, hard_negative=hard, sampler_seed=0, n_epoch=1, model_path=str(tmp_path), device="cpu")
        assert np.isfinite(trainer.train_one_epoch(ArrayLoader(x_pos, y[keep], batch_size=32, shuffle=True), log_interval=0))


def test_e2e_inbatch_sampling_exact():
    """The hand-computed hard negatives of ``tests/test_e2e_matching.py::test_inbatch_sampling_exact``."""
    scores = torch.tensor([[9.0, 1.0, 2.0, 3.0], [4.0, 9.0, 6.0, 5.0], [7.0, 8.0, 9.0, 1.0], [3.0, 2.0, 1.0, 9.0]])
    idx = inbatch_negative_sampling(scores, neg_ratio=2, hard_negative=True)
    np.testing.assert_array_equal(idx.numpy(), [[3, 2], [2, 3], [1, 0], [0, 1]])
    np.testing.assert_array_equal(gather_inbatch_logits(scores, idx)[:, 0].numpy(), [9.0] * 4)
    for seed in range(3):
        idx = inbatch_negative_sampling(scores, neg_ratio=3, generator=torch.Generator().manual_seed(seed))
        assert not (idx == torch.arange(4)[:, None]).any()


def test_e2e_steps_per_call_trajectory():
    """``steps_per_call`` groups run as single steps: the same losses as one step per call."""
    x_train, y, _ = prepare(mode=0)
    user, item, _ = user_item_features()

    def run(steps_per_call):
        model = tmatching.DSSM(user_features=user, item_features=item, user_params={"dims": (16, D)}, item_params={"dims": (16, D)}, generator=torch.Generator().manual_seed(0))
        trainer = MatchTrainer(model, mode=0, n_epoch=1, seed=0, steps_per_call=steps_per_call, device="cpu")
        return [trainer.train_one_epoch(ArrayLoader(x_train, y, batch_size=64), log_interval=0) for _ in range(2)]

    np.testing.assert_allclose(run(1), run(3), rtol=1e-6)


# ---------------------------------------------------------------------------
# evaluate / predict / fit(train, val) in each mode, and sparse tables read outside the gather hooks
# ---------------------------------------------------------------------------

def carried_pair(tmp_path, name, kw, sparse=None, opt=OPT):
    """A JAX MatchTrainer and the port's from the same redrawn weights (``name`` as ``build_match`` takes it)."""
    x, y = match_frame(BATCH - 14, seed=1)
    jtrainer = JMatchTrainer(build_match(jmatching, jfeat, name), optimizer_params=opt, model_path=str(tmp_path / "jax"), sparse_embedding=sparse, **kw)
    jtrainer._ensure_ready(jdata.ArrayLoader(x, labels(name, x, y), batch_size=BATCH))
    variables = redrawn({"params": np_tree(jtrainer.state.params), "batch_stats": np_tree(jtrainer.state.batch_stats)}, seed=3)
    jtrainer.state = jtrainer.state.replace(params=jax.tree_util.tree_map(jnp.asarray, variables["params"]), batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]))
    model = load_flax_params(build_match(tmatching, tfeat, name), variables["params"], variables["batch_stats"])
    trainer = MatchTrainer(model, optimizer_params=opt, model_path=str(tmp_path / "torch"), sparse_embedding=sparse, device="cpu", **kw)
    return jtrainer, trainer, variables, x, y


@pytest.mark.parametrize("name", ("DSSM", "FaceBookDSSM", "YoutubeDNN"))
def test_evaluate_predict_and_fit_match_jax_in_each_mode(tmp_path, name):
    """One class per mode (0 DSSM, 1 FaceBookDSSM, 2 YoutubeDNN) on carried weights and 50 rows, padded to 64
    where a batch is partial: ``predict`` stacks a pair-wise model's ``(pos, neg)`` into ``(2, B)`` per batch and
    cuts each batch's output to its first ``n`` entries on the first axis; ``evaluate`` scores the first ``n``
    values of each flattened batch output against the 0/1 labels (a list-wise model's columns mixed, as in
    JAX).  Outputs within the matching tests' OUT_RTOL / OUT_ATOL, the AUC equal (no pair of scores is
    that close); then ``fit(train, val)`` runs in the port, evaluating each epoch."""
    jtrainer, trainer, _, x, y = carried_pair(tmp_path, name, dict(mode=mode_of(name)))
    for batch_size in (BATCH, 32):  # one padded batch; a full and a padded one
        jpred = np.asarray(jtrainer.predict(jtrainer.model, jdata.ArrayLoader(x, y, batch_size=batch_size)))
        pred = trainer.predict(trainer.model, tdata.ArrayLoader(x, y, batch_size=batch_size))
        assert pred.shape == jpred.shape and pred.dtype == np.float32
        np.testing.assert_allclose(pred, jpred, rtol=OUT_RTOL, atol=OUT_ATOL)
        jauc = jtrainer.evaluate(jtrainer.model, jdata.ArrayLoader(x, y, batch_size=batch_size))
        auc = trainer.evaluate(trainer.model, tdata.ArrayLoader(x, y, batch_size=batch_size))
        assert 0.0 < auc < 1.0
        np.testing.assert_allclose(auc, jauc, rtol=0, atol=1e-12)
    if name == "FaceBookDSSM":
        assert pred.shape == (4, 32)  # (pos, neg) of 32 rows, then of 18 rows padded to 32
    trainer.n_epoch = 2
    trainer.fit(tdata.ArrayLoader(x, labels(name, x, y), batch_size=16), tdata.ArrayLoader(x, y, batch_size=16))
    assert trainer.early_stopper.best_weights is not None and os.path.exists(tmp_path / "torch" / "model.pt")


def test_sparse_table_read_outside_the_hooks_moves_as_in_jax(tmp_path, all_fused):
    """SASRec's item tower reads the fused table directly (``EmbeddingCollection.table``), outside the gather
    hooks.  One sparse SGD step (mode 0, user · item scores): the table takes no dense gradient
    (``.grad is None``), and its rows move by the hooks' gradients alone, as JAX's sparse step moves them,
    not by the full table gradient (which has the item tower's part too).  SGD at lr 0.05, so that part's
    step stands far above the tolerance."""
    lr = 0.05
    jtrainer, trainer, variables, x, y = carried_pair(tmp_path, "SASRec:towers", dict(mode=0), sparse="sgd", opt={"lr": lr, "weight_decay": WD})
    (table_name,) = trainer.sparse_tables
    assert table_name == "item_emb.fused_d8_table"
    before = flax_to_state_dict(variables["params"])[table_name]
    xp, yp, w = jdata.pad_batch(x, y, BATCH)

    def jloss(p):  # the dense loss: the item tower's read of the table takes its gradient here
        out, _ = jtrainer.model.apply({"params": p, "batch_stats": variables["batch_stats"]}, jax_batch(xp), training=True, mutable=["batch_stats"])
        from torch_rechub_tpu.basic.loss import bce_with_logits as jbce
        return jbce(out, jnp.asarray(yp), jnp.asarray(w))

    dense_grad = flax_to_state_dict(np_tree(jax.jit(jax.grad(jloss))(variables["params"])))[table_name]
    jloss_step = jtrainer.train_one_epoch(jdata.ArrayLoader(x, y, batch_size=BATCH), log_interval=0)
    loss = trainer.train_one_epoch(tdata.ArrayLoader(x, y, batch_size=BATCH), log_interval=0)
    np.testing.assert_allclose(loss, jloss_step, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    table = trainer.sparse_tables[table_name]
    assert table.grad is None
    after = flax_to_state_dict(np_tree(jtrainer.state.params))[table_name]
    np.testing.assert_allclose(table.detach().numpy(), after.numpy(), rtol=TABLE_RTOL, atol=TABLE_ATOL)
    items = np.unique(x["item_id"])
    dense_step = before.numpy() - lr * dense_grad.numpy()
    assert np.abs(after.numpy()[items] - dense_step[items]).max() > 100 * TABLE_ATOL  # the item tower's gradient is dropped


@pytest.mark.parametrize("name", ("NARM", "STAMP", "SINE"))
def test_raw_item_tables_are_dense_in_both_packages(tmp_path, all_fused, name):
    """NARM, STAMP and SINE read their items from a raw ``item_embedding`` parameter, not an
    ``EmbeddingCollection`` table: neither package has a sparse table to update, and both refuse
    ``sparse_embedding``; their towers' reads stay dense."""
    x, y = match_frame(16, seed=1)
    with pytest.raises(ValueError, match="fused"):
        JMatchTrainer(build_match(jmatching, jfeat, name), mode=2, sparse_embedding="sgd", model_path=str(tmp_path))._ensure_ready(jdata.ArrayLoader(x, labels(name, x, y), batch_size=16))
    model = build_match(tmatching, tfeat, name)
    assert "item_embedding" in dict(model.named_parameters())
    with pytest.raises(ValueError, match="no sparse-capable tables"):
        MatchTrainer(model, mode=2, sparse_embedding="sgd", device="cpu")
