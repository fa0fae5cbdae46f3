"""Step checkpoints and exact resume (``utils/checkpoint.py``, ``TorchTrainer.train_state`` /
``enable_step_checkpointing`` / ``maybe_step_checkpoint`` / ``maybe_resume``) against the JAX package, mirroring
``tests/test_checkpoint.py``.

For DeepFM (dense Adam, and sparse Adagrad over a fused table), MMOE under GradNorm and a 2-layer HSTU through
``SeqTrainer``, from the JAX package's initial weights carried into the port:

- the round trip of the full train state (save, a fresh trainer, ``maybe_resume``) is bit for bit;
- 4 steps, a checkpoint, a fresh trainer resumed from it, 4 more steps equal the port's 8 straight steps bit
  for bit (the CPU's sums are deterministic), and the JAX package's 8 straight steps at ``tests/test_checkpoint.py``'s
  rtol 1e-5, atol 1e-6 (HSTU at its LayerNorm tolerance 2e-4, ``test_torch_hstu_model.py``).  The Dense
  biases in front of a BatchNorm have an exact gradient of 0, and what each package takes for it is rounding
  noise that Adam turns into a move of up to ``lr`` per step; they, and the running means of the BatchNorms
  behind them (each batch mean holds the bias), are held to ``2 lr`` per step taken (``test_torch_mtl_train.py``
  holds the biases to ``2 lr`` after one step).

``CTRTrainer`` writes its checkpoints at the JAX package's steps (``steps_per_call`` 1 and 2); retention keeps
the newest ``max_to_keep``, no ``.tmp`` file is left, and a checkpoint of another shape raises, naming the tensors.
"""

import os

import jax
import numpy as np
import pytest
import torch

from test_torch_ctr_model import MLP_PARAMS, np_tree, schema
from test_torch_cuda_ranking import bn_invariant
from test_torch_cuda_mtl import TASK_TYPES, build_mtl
from test_torch_mtl_train import OPT as MTL_OPT
from test_torch_mtl_train import trainer_pair
from test_torch_seq_eval import MODEL_KW, seq_data
from torch_rechub_tpu.basic import features as jfeat
from torch_rechub_tpu.models.generative.hstu import HSTUModel as JHSTUModel
from torch_rechub_tpu.models.ranking import DeepFM as JDeepFM
from torch_rechub_tpu.ops import embedding as jemb
from torch_rechub_tpu.trainers.ctr_trainer import CTRTrainer as JCTRTrainer
from torch_rechub_tpu.trainers.seq_trainer import SeqTrainer as JSeqTrainer
from torch_rechub_tpu.utils import checkpoint as jckpt
from torch_rechub_tpu.utils import data as jdata
from torch_rechub_tpu_torch.basic import features as tfeat
from torch_rechub_tpu_torch.models import multi_task as tmt
from torch_rechub_tpu_torch.models.generative.hstu import HSTUModel
from torch_rechub_tpu_torch.models.ranking import DeepFM
from torch_rechub_tpu_torch.ops import embedding as temb
from torch_rechub_tpu_torch.trainers import CTRTrainer, MTLTrainer, SeqTrainer
from torch_rechub_tpu_torch.utils import checkpoint as tckpt
from torch_rechub_tpu_torch.utils import data as tdata
from torch_rechub_tpu_torch.utils.checkpoint import TrainCheckpointer, flat_tensors
from torch_rechub_tpu_torch.utils.jax_weights import flax_to_state_dict, load_flax_params

LR = 1e-3
CTR_OPT = {"lr": LR, "weight_decay": 1e-5}
RTOL, ATOL = 1e-5, 1e-6  # tests/test_checkpoint.py
HSTU_RTOL = 2e-4  # the layers' LayerNorm tolerance (test_torch_hstu_model.py)
BATCH, HALF = 32, 4  # 8 steps of 32 rows, split 4 + 4


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def ctr_rows(n, seed=0):
    rng = np.random.default_rng(seed)
    x = {f"C{i}": rng.integers(0, 64, n).astype(np.int32) for i in range(5)}
    x.update({f"I{i}": rng.normal(size=n).astype(np.float32) for i in range(3)})
    return x, rng.integers(0, 2, n).astype(np.float32)


def rows(x, y, s):
    return {k: v[s] for k, v in x.items()}, y[s]


def assert_states_equal(a, b):
    fa, fb = dict(flat_tensors(a)), dict(flat_tensors(b))
    assert fa.keys() == fb.keys()
    for k, v in fa.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, fb[k]), k
        else:
            assert v == fb[k], k


def assert_near_jax(model, jparams, jstats, rtol, steps):
    ref = flax_to_state_dict(np_tree(jparams))
    ref.update(flax_to_state_dict(np_tree(jstats or {})))
    state = model.state_dict()
    biases = bn_invariant(set(state))
    invariant = biases | {b.rsplit("Dense_", 1)[0] + "BatchNorm_" + b.rsplit("Dense_", 1)[1][: -len(".bias")] + ".mean" for b in biases}
    assert set(state) <= set(ref) | {n for n in state if n.endswith("bucket_thresholds")}
    for name, t in state.items():
        if name not in ref:
            continue
        tol = dict(rtol=0, atol=2 * LR * steps) if name in invariant else dict(rtol=rtol, atol=ATOL)
        np.testing.assert_allclose(t.detach().numpy(), ref[name].numpy(), err_msg=name, **tol)


def resume_run(build, first, second, train, directory, every=HALF, auto=False):
    """4 steps, a checkpoint, a fresh trainer resumed from it, 4 more; returns (resumed trainer, the checkpointed trainer)."""
    t1 = build()
    ckpt = t1.enable_step_checkpointing(directory, every_n_steps=every)
    train(t1, first)
    if not auto:  # CTRTrainer's loop saves by itself; the others are saved by the caller, as in the JAX package
        t1.maybe_step_checkpoint()
    assert ckpt.latest_step() == t1.step == HALF
    t2 = build()
    t2.enable_step_checkpointing(directory, every_n_steps=every)
    assert t2.maybe_resume() == HALF
    assert_states_equal(t2.train_state(), t1.train_state())  # the round trip, bit for bit
    train(t2, second)
    return t2, t1


def ctr_models(sparse):
    (js, jd), (ts, td) = schema(jfeat), schema(tfeat)
    return JDeepFM(deep_features=jd + js, fm_features=js, mlp_params=MLP_PARAMS), lambda: DeepFM(td + ts, ts, MLP_PARAMS)


@pytest.mark.parametrize("sparse", [None, "adagrad"], ids=["dense_adam", "sparse_adagrad"])
def test_deepfm_resume_is_exact_and_matches_jax(tmp_path, sparse):
    old = (jemb.set_fused_default(True), temb.set_fused_default(True)) if sparse else None
    try:
        x, y = ctr_rows(2 * HALF * BATCH)
        jmodel, tmodel = ctr_models(sparse)
        jtrainer = JCTRTrainer(jmodel, optimizer_params=CTR_OPT, model_path=str(tmp_path / "jax"), sparse_embedding=sparse)
        jtrainer._ensure_ready(jdata.ArrayLoader(x, y, batch_size=BATCH))
        params, stats = np_tree(jtrainer.state.params), np_tree(jtrainer.state.batch_stats)

        def build():
            return CTRTrainer(load_flax_params(tmodel(), params, stats), optimizer_params=CTR_OPT, model_path=str(tmp_path / "torch"), sparse_embedding=sparse, device="cpu")

        def train(t, part):
            t.train_one_epoch(tdata.ArrayLoader(*part, batch_size=BATCH), log_interval=0)

        first, second = rows(x, y, slice(0, HALF * BATCH)), rows(x, y, slice(HALF * BATCH, None))
        resumed, _ = resume_run(build, first, second, train, str(tmp_path / "ckpts"), auto=True)
        straight = build()
        train(straight, (x, y))
        assert resumed.step == straight.step == 2 * HALF
        assert_states_equal(resumed.train_state(), straight.train_state())

        jtrainer.train_one_epoch(jdata.ArrayLoader(x, y, batch_size=BATCH), log_interval=0)
        assert int(jtrainer.state.step) == resumed.step
        assert_near_jax(resumed.model, jtrainer.state.params, jtrainer.state.batch_stats, RTOL, resumed.step)
        if sparse:  # the row-wise accumulators: the sparse opt_state
            (name,) = resumed.sparse_accums
            jaccum = flax_to_state_dict(np_tree(jtrainer.state.opt_state[1]))[name]
            np.testing.assert_allclose(resumed.sparse_accums[name].numpy(), jaccum.numpy(), rtol=RTOL, atol=ATOL)
    finally:
        if old:
            jemb.set_fused_default(old[0])
            temb.set_fused_default(old[1])


def test_mtl_gradnorm_resume_is_exact_and_matches_jax(tmp_path):
    """MMOE under GradNorm: the state adds loss_weight, mb_norms and initial_task_loss (MTLTrainState)."""
    jtrainer, _, variables, x, ys = trainer_pair(tmp_path, "MMOE", "gradnorm", n=2 * HALF * BATCH)

    def build():
        model = load_flax_params(build_mtl(tmt, tfeat, "MMOE"), variables["params"], variables["batch_stats"])
        return MTLTrainer(model, TASK_TYPES, optimizer_params=MTL_OPT, adaptive_params={"method": "gradnorm"}, device="cpu")

    def train(t, part):
        t.train_one_epoch(tdata.ArrayLoader(*part, batch_size=BATCH), log_interval=0)

    first, second = rows(x, ys, slice(0, HALF * BATCH)), rows(x, ys, slice(HALF * BATCH, None))
    resumed, checkpointed = resume_run(build, first, second, train, str(tmp_path / "ckpts"))
    assert float(checkpointed.initial_task_loss.abs().sum()) > 0  # set by the first step, carried by the state
    straight = build()
    train(straight, (x, ys))
    assert_states_equal(resumed.train_state(), straight.train_state())

    jtrainer.train_one_epoch(jdata.ArrayLoader(x, ys, batch_size=BATCH), log_interval=0)
    assert_near_jax(resumed.model, jtrainer.state.params, jtrainer.state.batch_stats, RTOL, resumed.step)
    np.testing.assert_allclose(resumed.loss_weight.detach().numpy(), np.asarray(jtrainer.state.loss_weight), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(resumed.initial_task_loss.numpy(), np.asarray(jtrainer.state.initial_task_loss), rtol=RTOL, atol=ATOL)


def test_hstu_resume_is_exact_and_matches_jax(tmp_path):
    """A 2-layer HSTU through SeqTrainer: the steps launch the attention's plain forward and backward here."""
    toks, pos, tgts, tds = seq_data(n=2 * HALF * 8, seed=5)
    jtrainer = JSeqTrainer(JHSTUModel(**MODEL_KW), model_path=str(tmp_path / "jax"))
    jtrainer._ensure_ready(jdata.SeqLoader(toks[:8], pos[:8], tgts[:8], tds[:8], batch_size=8))
    params = np_tree(jtrainer.state.params)

    def build():
        return SeqTrainer(load_flax_params(HSTUModel(**MODEL_KW), params), model_path=str(tmp_path / "torch"), device="cpu")

    def train(t, part):
        t.train_one_epoch(tdata.SeqLoader(*part, batch_size=8), log_interval=0)

    half = HALF * 8
    first = tuple(a[:half] for a in (toks, pos, tgts, tds))
    second = tuple(a[half:] for a in (toks, pos, tgts, tds))
    resumed, _ = resume_run(build, first, second, train, str(tmp_path / "ckpts"))
    straight = build()
    train(straight, (toks, pos, tgts, tds))
    assert_states_equal(resumed.train_state(), straight.train_state())

    jtrainer.train_one_epoch(jdata.SeqLoader(toks, pos, tgts, tds, batch_size=8), log_interval=0)
    assert int(jtrainer.state.step) == resumed.step == 2 * HALF
    assert_near_jax(resumed.model, jtrainer.state.params, None, HSTU_RTOL, resumed.step)


@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_ctr_trainer_checkpoints_at_the_jax_steps(tmp_path, monkeypatch, steps_per_call):
    """7 batches, a checkpoint every 3 steps, checked once per group: the steps saved and the files kept."""
    x, y = ctr_rows(7 * 16, seed=1)
    jmodel, tmodel = ctr_models(None)
    saved = {"jax": [], "port": []}
    tsave = tckpt.TrainCheckpointer.save
    monkeypatch.setattr(jckpt.TrainCheckpointer, "save", lambda self, step, state: saved["jax"].append(step))  # the steps alone
    monkeypatch.setattr(tckpt.TrainCheckpointer, "save", lambda self, step, state: (saved["port"].append(step), tsave(self, step, state))[1])
    jtrainer = JCTRTrainer(jmodel, model_path=str(tmp_path / "jax"), steps_per_call=steps_per_call)
    jtrainer._ensure_ready(jdata.ArrayLoader(x, y, batch_size=16))
    jtrainer.enable_step_checkpointing(str(tmp_path / "jax_ckpts"), every_n_steps=3, max_to_keep=2)
    jtrainer.train_one_epoch(jdata.ArrayLoader(x, y, batch_size=16), log_interval=0)
    trainer = CTRTrainer(tmodel(), model_path=str(tmp_path / "torch"), steps_per_call=steps_per_call, device="cpu")
    ckpt = trainer.enable_step_checkpointing(str(tmp_path / "ckpts"), every_n_steps=3, max_to_keep=2)
    trainer.train_one_epoch(tdata.ArrayLoader(x, y, batch_size=16), log_interval=0)
    assert saved["port"] == saved["jax"] == ([3, 6] if steps_per_call == 1 else [6])
    assert trainer.step == int(jtrainer.state.step) == 7
    assert sorted(os.listdir(ckpt.directory)) == [f"ckpt_{s}.pt" for s in saved["port"][-2:]]


def test_retention_no_tmp_left_and_mismatched_shapes_raise(tmp_path):
    ckpt = TrainCheckpointer(str(tmp_path), max_to_keep=2)
    state = {"model": {"w": torch.zeros(3, 4), "EmbeddingCollection_0.C0_table": torch.zeros(70_000, 8)}, "step": 0}
    for step in (1, 2, 3, 4):
        ckpt.save(step, {**state, "step": step})
    assert sorted(os.listdir(tmp_path)) == ["ckpt_3.pt", "ckpt_4.pt"] and ckpt.latest_step() == 4
    restored, step = ckpt.restore(state)
    assert step == 4 and restored["step"] == 4
    assert TrainCheckpointer(str(tmp_path / "empty")).restore(state) == (state, None)
    other = {"model": {"w": torch.zeros(3, 5), "EmbeddingCollection_0.C0_table": torch.zeros(70_000, 8), "b": torch.zeros(2)}, "step": 0}
    with pytest.raises(ValueError, match=r"/model/w: checkpoint \(3, 4\) vs model \(3, 5\); .*/model/b: missing from the checkpoint|/model/b: missing"):
        ckpt.restore(other)
    padded = {"model": {"w": torch.zeros(3, 4), "EmbeddingCollection_0.C0_table": torch.zeros(70_016, 8)}, "step": 0}
    with pytest.raises(ValueError, match="ROW counts"):
        ckpt.restore(padded)
