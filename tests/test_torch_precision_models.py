"""bf16 mixed precision (``basic/precision.py``) in the port's ranking, matching, multi-task and generative
models against the JAX package on the CPU: one bf16 step of DeepFM, AutoInt, DSSM with in-batch negatives,
MMOE under UWL / MetaBalance and HLLM, and TIGER's forward, under ``precision_scope("bf16")``; then a bf16
epoch of every model of the zoo.  The helpers and the tolerances (the quarter rule for the forward, a
stated gradient tolerance for XLA's CPU bf16 reductions) are ``tests/test_torch_precision.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cuda_generative import HLLM_KW, TIGER_KW, hllm_data, item_embeddings, tiger_data
from test_torch_cuda_matching import MATCH_MODELS, build_match, labels, match_frame, mode_of
from test_torch_cuda_mtl import MTL_MODELS, TASK_TYPES, build_mtl, mtl_frame, task_types_of
from test_torch_cuda_ranking import CTR_MODELS, SEQ_MODELS, build, ctr_frame, seq_frame
from test_torch_precision import BF16, assert_bf16_like_jax, assert_f32_state, assert_grads_like_jax, before_batchnorm, f32, jax_grads, np_tree, one_thread, port_step  # noqa: F401 (one_thread: the autouse fixture)
from torch_rechub_tpu.basic import features as jfeat
from torch_rechub_tpu.basic.loss import bce_with_logits as jbce
from torch_rechub_tpu.basic.loss import softmax_cross_entropy as jsoftmax_ce
from torch_rechub_tpu.basic.precision import precision_scope as jscope
from torch_rechub_tpu.models import matching as jmatching
from torch_rechub_tpu.models import multi_task as jmt
from torch_rechub_tpu.models import ranking as jranking
from torch_rechub_tpu.models.generative.hllm import HLLMModel as JHLLMModel
from torch_rechub_tpu.models.generative.tiger import TIGERModel as JTIGERModel
from torch_rechub_tpu.ops import chunked_ce as jce
from torch_rechub_tpu.trainers import mtl_trainer as jmtl_trainer
from torch_rechub_tpu.utils.match import gather_inbatch_logits as jgather, inbatch_negative_sampling as jsample
from torch_rechub_tpu_torch.basic import features as tfeat
from torch_rechub_tpu_torch.basic import precision as tprec
from torch_rechub_tpu_torch.models import matching as tmatching
from torch_rechub_tpu_torch.models import multi_task as tmt
from torch_rechub_tpu_torch.models import ranking as tranking
from torch_rechub_tpu_torch.models.generative.hllm import HLLMModel
from torch_rechub_tpu_torch.models.generative.tiger import TIGERModel
from torch_rechub_tpu_torch.trainers import CTRTrainer, MatchTrainer, MTLTrainer, SeqTrainer
from torch_rechub_tpu_torch.trainers.mtl_trainer import _aggregate_losses
from torch_rechub_tpu_torch.utils import data as tdata
from torch_rechub_tpu_torch.utils.jax_weights import load_flax_params


# ---------------------------------------------------------------------------
# the ranking, matching and multi-task paths: one step each
# ---------------------------------------------------------------------------

def redrawn_variables(jmodel, x, seed):
    """A flax model's variables with every embedding table redrawn at N(0, 0.3²) (1e-4 tables keep every
    product near zero, where bf16 and f32 agree)."""
    variables = np_tree(jmodel.init({"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1)}, x, training=False))
    rng = np.random.default_rng(seed)

    def table(path, a):
        return (rng.normal(size=a.shape) * 0.3).astype(np.float32) if str(path[-1].key).endswith("_table") else a

    return {"params": jax.tree_util.tree_map_with_path(table, variables["params"]), "batch_stats": variables.get("batch_stats", {})}


def ranking_case(name):
    x, y = ctr_frame(64, seed=3)
    jmodel = build(jranking, jfeat, name)
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    variables = redrawn_variables(jmodel, jx, 5)

    def jloss(p):
        out, _ = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]}, jx, training=True, mutable=["batch_stats"])
        return jbce(out, jnp.asarray(y), jnp.ones(64, jnp.float32)), out

    ref = jax_grads(jloss, variables["params"])
    model = load_flax_params(build(tranking, tfeat, name), variables["params"], variables["batch_stats"])
    trainer = CTRTrainer(model, precision="bf16", device="cpu")
    tx, ty, w = {k: torch.from_numpy(v) for k, v in x.items()}, torch.from_numpy(y), torch.ones(64)
    model.train()

    def loss_fn():
        out = model(tx)
        return trainer.loss_fn(tx, ty, w), out

    loss, out = port_step(model, loss_fn)
    return trainer, loss, out, ref, (x, y)


@pytest.mark.parametrize("name", ["DeepFM", "AutoInt"])
def test_ranking_bf16_step_matches_jax(name):
    """The logits (bf16) to one ulp of the largest, the loss to 1e-5; the gradients as the module docstring says;
    then ``fit``-style epochs keep every parameter and Adam moment in f32, and ``predict`` returns f32."""
    trainer, loss, out, ref, (x, y) = ranking_case(name)
    assert out.dtype == BF16
    assert_bf16_like_jax(out, ref["bf16"][1], ref["f32"][1], 0, 2**-7 * float(np.abs(f32(ref["bf16"][1])).max()), "logits")
    assert_bf16_like_jax(loss, ref["bf16"][0], ref["f32"][0], 1e-5, 1e-6, "loss")
    assert_grads_like_jax(dict(trainer.model.named_parameters()), ref["bf16"][2], ref["f32"][2], before_batchnorm(trainer.model))
    trainer.train_one_epoch(tdata.ArrayLoader(x, y, batch_size=32), log_interval=0)
    assert_f32_state(trainer)
    assert trainer.predict(trainer.model, tdata.ArrayLoader(x, batch_size=32)).dtype == np.float32


def test_dssm_inbatch_bf16_step_matches_jax():
    """DSSM's towers and the in-batch softmax over every other row of the batch (``in_batch_neg_ratio=None``:
    the loss is the same whatever order the negatives take)."""
    x, _ = match_frame(64, seed=4)
    jmodel = build_match(jmatching, jfeat, "DSSM")
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    variables = redrawn_variables(jmodel, jx, 6)
    w = np.ones(64, np.float32)

    def jloss(p):
        (user, item), _ = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]}, jx, training=True, mutable=["batch_stats"], method="towers")
        user, item = user.reshape(64, -1), item.reshape(64, -1)
        scores = user @ item.T
        logits = jgather(scores, jsample(scores, neg_ratio=None, hard_negative=False, rng=jax.random.PRNGKey(0)))
        return jsoftmax_ce(logits, jnp.zeros(64, jnp.int32), weight=jnp.asarray(w)), scores

    ref = jax_grads(jloss, variables["params"])
    model = load_flax_params(build_match(tmatching, tfeat, "DSSM"), variables["params"], variables["batch_stats"])
    trainer = MatchTrainer(model, mode=2, in_batch_neg=True, precision="bf16", device="cpu")
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    model.train()

    def loss_fn():
        user, item = model.towers(tx)
        return trainer.loss_fn(tx, None, torch.from_numpy(w)), user.reshape(64, -1) @ item.reshape(64, -1).T

    loss, scores = port_step(model, loss_fn)
    assert_bf16_like_jax(scores, ref["bf16"][1], ref["f32"][1], 0, 2**-7 * float(np.abs(f32(ref["bf16"][1])).max()), "scores")
    assert_bf16_like_jax(loss, ref["bf16"][0], ref["f32"][0], 1e-5, 1e-6, "loss")
    assert_grads_like_jax(dict(model.named_parameters()), ref["bf16"][2], ref["f32"][2], before_batchnorm(model))
    trainer.train_one_epoch(tdata.ArrayLoader(x, np.zeros(64, np.float32), batch_size=32), log_interval=0)
    assert_f32_state(trainer)
    emb = trainer.inference_embedding(model, "user", tdata.ArrayLoader(x, batch_size=32), "")
    assert emb.dtype == np.float32


@pytest.mark.parametrize("method", ["uwl", "metabalance"])
def test_mmoe_bf16_step_matches_jax(method):
    """MMOE's predictions (bf16) and the aggregated task losses (f32) against the JAX package's; UWL's loss
    weights and MetaBalance's norms stay f32 through a trainer epoch."""
    x, ys = mtl_frame(64, seed=5)
    jmodel = build_mtl(jmt, jfeat, "MMOE")
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    variables = redrawn_variables(jmodel, jx, 7)
    w = np.ones(64, np.float32)

    def jloss(p):
        out, _ = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]}, jx, training=True, mutable=["batch_stats"])
        losses = jnp.stack([jmtl_trainer._task_loss(out[:, i], jnp.asarray(ys[:, i]), t, jnp.asarray(w)) for i, t in enumerate(TASK_TYPES)])
        return jmtl_trainer._aggregate_losses(losses, jnp.zeros(2, jnp.float32), "uwl", False), out

    ref = jax_grads(jloss, variables["params"])
    model = load_flax_params(build_mtl(tmt, tfeat, "MMOE"), variables["params"], variables["batch_stats"])
    trainer = MTLTrainer(model, TASK_TYPES, adaptive_params={"method": method}, precision="bf16", device="cpu")
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    model.train()

    def loss_fn():
        out = model(tx)
        losses = trainer.task_losses(out, torch.from_numpy(ys), torch.from_numpy(w))
        return _aggregate_losses(losses, torch.zeros(2), "uwl", False), out

    loss, out = port_step(model, loss_fn)
    assert out.dtype == BF16
    assert_bf16_like_jax(out, ref["bf16"][1], ref["f32"][1], 0, 2**-8, "predictions")
    assert_bf16_like_jax(loss, ref["bf16"][0], ref["f32"][0], 1e-5, 1e-6, "loss")
    assert_grads_like_jax(dict(model.named_parameters()), ref["bf16"][2], ref["f32"][2], before_batchnorm(model))
    trainer.train_one_epoch(tdata.ArrayLoader(x, ys, batch_size=32), log_interval=0)
    assert_f32_state(trainer)
    if method == "uwl":
        assert trainer.loss_weight.dtype == torch.float32
    else:
        assert {v.dtype for v in trainer.mb_norms.values()} == {torch.float32}
    assert trainer.predict(model, tdata.ArrayLoader(x, batch_size=32)).dtype == np.float32


# ---------------------------------------------------------------------------
# the generative models: HLLM's chunked step, TIGER's forward
# ---------------------------------------------------------------------------

def test_hllm_bf16_chunked_step_matches_jax():
    """HLLM's residual stream stays f32 under the policy (its LayerNorms and the f32 position bias promote), so
    the hidden states are f32 here as there; the Dense layers round."""
    toks, pos, tgts, tds = hllm_data(8, seed=1)
    jmodel = JHLLMModel(item_embeddings=item_embeddings(), **HLLM_KW)
    variables = np_tree(jmodel.init(jax.random.PRNGKey(2), jnp.asarray(toks), jnp.asarray(tds), training=False))

    def jloss(p):
        out = jmodel.apply({"params": p, "constants": variables["constants"]}, jnp.asarray(toks), jnp.asarray(tds), training=True, return_hidden=True)
        return jce.chunked_next_token_loss(out["hidden"], out["weight"], jnp.asarray(toks), jnp.asarray(tgts), None, jmodel.temperature, 0, 16), out["hidden"]

    ref = jax_grads(jloss, variables["params"])
    model = load_flax_params(HLLMModel(item_embeddings=item_embeddings(), **HLLM_KW), variables["params"], constants=variables["constants"])
    trainer = SeqTrainer(model, vocab_chunk_size=16, precision="bf16", device="cpu")
    batch = [torch.from_numpy(a) for a in (toks, tds, tgts)]
    model.train()

    def loss_fn():
        return trainer.loss_fn(*batch), model(batch[0], batch[1], return_hidden=True)["hidden"]

    loss, hidden = port_step(model, loss_fn)
    assert hidden.dtype == torch.float32
    assert_bf16_like_jax(hidden, ref["bf16"][1], ref["f32"][1], 0, 2**-8, "hidden")
    assert_bf16_like_jax(loss, ref["bf16"][0], ref["f32"][0], 1e-5, 1e-6, "loss")
    # a softmax over keys is blind to a bias added to every key: W_K.bias's exact gradient is 0 (noise, not compared)
    key_biases = {name for name, _ in model.named_parameters() if name.endswith("W_K.bias")}
    assert_grads_like_jax(dict(model.named_parameters()), ref["bf16"][2], ref["f32"][2], key_biases)
    trainer.train_one_epoch(tdata.SeqLoader(toks, pos, tgts, tds, batch_size=4), log_interval=0)
    assert_f32_state(trainer)


def test_tiger_bf16_forward_matches_jax():
    """TIGER's loss and logits under the scope: its attention and FFN Dense layers and softmaxes in bf16, the
    residual stream (LayerNorm outputs) and the tied logits in f32."""
    x, labels = tiger_data(8, seed=3)
    jmodel = JTIGERModel(**TIGER_KW)
    params = np_tree(jmodel.init({"params": jax.random.PRNGKey(4), "dropout": jax.random.PRNGKey(1)}, jnp.asarray(x), labels=jnp.asarray(labels)))["params"]
    ref = {}
    for prec in ("bf16", "f32"):
        with jscope(prec):
            loss, logits = jmodel.apply({"params": params}, jnp.asarray(x), labels=jnp.asarray(labels))
        ref[prec] = (float(loss), logits)
    model = load_flax_params(TIGERModel(**TIGER_KW), params)
    model.eval()
    with tprec.precision_scope("bf16"):
        loss, logits = model(torch.from_numpy(x), labels=torch.from_numpy(labels))
    assert logits.dtype == torch.float32
    assert_bf16_like_jax(logits, ref["bf16"][1], ref["f32"][1], 0, 2**-7 * float(np.abs(f32(ref["bf16"][1])).max()), "logits")
    assert_bf16_like_jax(loss, ref["bf16"][0], ref["f32"][0], 1e-5, 1e-6, "loss")


# ---------------------------------------------------------------------------
# every model of the zoo trains under the policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CTR_MODELS + SEQ_MODELS + tuple("match:" + n for n in MATCH_MODELS) + tuple("mtl:" + n for n in MTL_MODELS))
def test_every_model_trains_a_bf16_epoch(name):
    """Two bf16 steps and a prediction of each model through its trainer on the CPU: where a bf16 tensor
    meets an f32 one the port promotes as jnp does, so nothing mixes dtypes; the losses are finite and the
    parameters stay f32.  (The forward and gradients of the models above are held against the JAX package.)"""
    kind, _, model_name = name.rpartition(":")
    if kind == "match":
        x, y = match_frame(64)
        trainer = MatchTrainer(build_match(tmatching, tfeat, model_name), mode=mode_of(model_name), precision="bf16", device="cpu")
        loss = trainer.train_one_epoch(tdata.ArrayLoader(x, labels(model_name, x, y), batch_size=32), log_interval=0)
        out = trainer.predict(trainer.model, tdata.ArrayLoader(x, batch_size=32))
    elif kind == "mtl":
        x, ys = mtl_frame(64, esmm=model_name == "ESMM")
        trainer = MTLTrainer(build_mtl(tmt, tfeat, model_name), task_types_of(model_name), precision="bf16", device="cpu")
        loss = trainer.train_one_epoch(tdata.ArrayLoader(x, ys, batch_size=32), log_interval=0)
        out = trainer.predict(trainer.model, tdata.ArrayLoader(x, batch_size=32))
    else:
        x, y = seq_frame(64) if model_name in SEQ_MODELS else ctr_frame(64)
        trainer = CTRTrainer(build(tranking, tfeat, model_name), loss_mode=model_name != "DIEN", precision="bf16", device="cpu")
        loss = trainer.train_one_epoch(tdata.ArrayLoader(x, y, batch_size=32), log_interval=0)
        out = trainer.predict(trainer.model, tdata.ArrayLoader(x, batch_size=32))
    assert np.all(np.isfinite(loss)) and out.dtype == np.float32 and np.all(np.isfinite(out))
    assert {p.dtype for p in trainer.model.parameters()} == {torch.float32}
    assert tprec.precision() == "float32"
