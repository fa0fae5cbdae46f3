"""The port's Criteo-shaped ranking zoo (WideDeep, DCN, DCNv2, EDCN, AFM,
AutoInt, FiBiNet, DeepFFM, FatDeepFFM) against the JAX package on carried
weights, at the sizes of ``tests/test_e2e_ranking.py`` with dropout 0.

For each configuration: eval logits and train logits with the BatchNorm
statistics they leave; ``check_train_step`` holds one ``CTRTrainer`` step
against the JAX package's from the same weights and Adam (loss, gradients,
every parameter after the step).  The embedding
tables are redrawn at N(0, 0.3²) and the running statistics moved off their
start, so the logits are not the near-zero ones of a fresh model's 1e-4
tables.  Then the other options of DCNv2, EDCN and FiBiNet, the flax names,
AFM's constant attention and the port's mirror of ``test_ranking_fit_evaluate``.
The steps run in ``test_torch_ranking_train.py``; DeepFM's own parity tests
are in ``test_torch_ctr_*.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ctr_model import np_tree
from test_torch_cuda_ranking import CTR_MODELS, VARIANTS, LOGIT_ATOL, LOGIT_RTOL, LOSS_ATOL, LOSS_RTOL, LR, STATS_ATOL, STATS_RTOL, WD, build, check_step, frame
from torch_rechub_tpu.basic import features as jfeat
from torch_rechub_tpu.basic.loss import bce_with_logits as jbce
from torch_rechub_tpu.models import ranking as jranking
from torch_rechub_tpu.trainers.ctr_trainer import CTRTrainer as JCTRTrainer
from torch_rechub_tpu.utils import data as jdata
from torch_rechub_tpu_torch.basic import features as tfeat
from torch_rechub_tpu_torch.basic.loss import bce_with_logits
from torch_rechub_tpu_torch.models import ranking as tranking
from torch_rechub_tpu_torch.trainers import CTRTrainer
from torch_rechub_tpu_torch.utils import data as tdata
from torch_rechub_tpu_torch.utils.jax_weights import flax_to_state_dict, load_flax_params

ZOO = tuple(n for n in CTR_MODELS if n != "DeepFM")
OPT = {"lr": LR, "weight_decay": WD}


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def redrawn(variables, seed):
    """``params`` with every embedding table redrawn at N(0, 0.3²); the running means moved by N(0, 0.3²),
    the variances scaled by U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def table(path, a):
        return (rng.normal(size=a.shape) * 0.3).astype(np.float32) if str(path[-1].key).endswith("_table") else a

    params = jax.tree_util.tree_map_with_path(table, variables["params"])
    def stat(path, a):
        moved = a * rng.uniform(0.5, 1.5, a.shape) if path[-1].key == "var" else a + rng.normal(size=a.shape) * 0.3
        return moved.astype(np.float32)

    stats = jax.tree_util.tree_map_with_path(stat, variables.get("batch_stats", {}))
    return {"params": params, "batch_stats": stats}


def jax_batch(x):
    return {k: jnp.asarray(v) for k, v in x.items()}


def carried(name, seed=0):
    """A flax model of the configuration, its redrawn variables, and the port's model carrying them."""
    jmodel = build(jranking, jfeat, name)
    x, _ = frame(name, 8)
    init = jax.jit(lambda rng, batch: jmodel.init(rng, batch, training=False))  # one compile, not one per op
    variables = redrawn(np_tree(init(jax.random.PRNGKey(seed), jax_batch(x))), seed)
    model = load_flax_params(build(tranking, tfeat, name), variables["params"], variables["batch_stats"])
    return jmodel, variables, model


def split_aux(name, out):
    """``(logits, aux)``: DIEN returns both, every other model its logits only."""
    return out if name == "DIEN" else (out, None)


def check_stats(model, batch_stats):
    """The BatchNorm statistics against flax's ``batch_stats`` (the index buffers of the pair layers left out)."""
    ref = flax_to_state_dict(batch_stats)
    stats = {k: b for k, b in model.named_buffers() if b.is_floating_point()}
    assert set(stats) == set(ref)
    for key, b in stats.items():
        np.testing.assert_allclose(b.numpy(), ref[key].numpy(), rtol=STATS_RTOL, atol=STATS_ATOL, err_msg=key)


def check_forward(name):
    """Eval and train logits (DIEN's aux loss too) and the train forward's BatchNorm statistics."""
    jmodel, variables, model = carried(name)
    x, _ = frame(name, 48, seed=7)
    jx, tx = jax_batch(x), {k: torch.from_numpy(v) for k, v in x.items()}
    both = jax.jit(lambda v, batch: (jmodel.apply(v, batch, training=False), jmodel.apply(v, batch, training=True, mutable=["batch_stats"])))
    ref_eval, (ref_train, mutated) = both(variables, jx)
    ref_eval = split_aux(name, ref_eval)
    for ref, got in ((ref_eval, model.eval()(tx)), (split_aux(name, ref_train), model.train()(tx))):
        (ref_logits, ref_aux), (logits, aux) = ref, split_aux(name, got)
        assert logits.shape == (48,)
        np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref_logits), rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
        if ref_aux is not None:
            np.testing.assert_allclose(float(aux.detach()), float(ref_aux), rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    assert float(np.abs(np.asarray(ref_eval[0])).max()) > 0.05  # the redrawn tables reach the logits
    check_stats(model, np_tree(mutated.get("batch_stats", {})))


def check_train_step(tmp_path, name):
    """One step on a partial batch of 50 padded to 64, from the same weights: the JAX CTRTrainer's
    against the port's (loss, gradients, parameters after Adam, BatchNorm statistics)."""
    loss_mode = name != "DIEN"
    jtrainer = JCTRTrainer(build(jranking, jfeat, name), optimizer_params=OPT, loss_mode=loss_mode, model_path=str(tmp_path / "jax"))
    x, y = frame(name, 50, seed=1)
    jtrainer._ensure_ready(jdata.ArrayLoader(x, y, batch_size=64))
    variables = redrawn({"params": np_tree(jtrainer.state.params), "batch_stats": np_tree(jtrainer.state.batch_stats)}, seed=3)
    jtrainer.state = jtrainer.state.replace(params=jnp_tree(variables["params"]), batch_stats=jnp_tree(variables["batch_stats"]))
    model = load_flax_params(build(tranking, tfeat, name), variables["params"], variables["batch_stats"])
    trainer = CTRTrainer(model, optimizer_params=OPT, loss_mode=loss_mode, model_path=str(tmp_path / "torch"), device="cpu")

    xp, yp, w = jdata.pad_batch(x, y, 64)

    def jloss(p):
        out, _ = jtrainer.model.apply({"params": p, "batch_stats": variables["batch_stats"]}, jax_batch(xp), training=True, mutable=["batch_stats"])
        logits, aux = split_aux(name, out)
        return jbce(logits, jnp.asarray(yp), jnp.asarray(w)) + (0.0 if aux is None else aux)

    ref_loss, jgrads = jax.jit(jax.value_and_grad(jloss))(variables["params"])
    jstep_loss = jtrainer.train_one_epoch(jdata.ArrayLoader(x, y, batch_size=64), log_interval=0)
    loss = trainer.train_one_epoch(tdata.ArrayLoader(x, y, batch_size=64), log_interval=0)
    np.testing.assert_allclose(jstep_loss, float(ref_loss), rtol=1e-6)
    np.testing.assert_allclose(loss, jstep_loss, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    named = dict(trainer.model.named_parameters())
    ref_grads, before, ref_after = ({k: v.numpy() for k, v in flax_to_state_dict(t).items()} for t in (np_tree(jgrads), variables["params"], np_tree(jtrainer.state.params)))
    check_step({k: p.grad.numpy() for k, p in named.items()}, {k: p.detach().numpy() for k, p in named.items()}, ref_grads, ref_after, before, 64, ref_grad_noise=True)
    check_stats(trainer.model, np_tree(jtrainer.state.batch_stats))


@pytest.mark.parametrize("name", ZOO)
def test_zoo_matches_jax(name):
    check_forward(name)


@pytest.mark.parametrize("name", VARIANTS)
def test_zoo_options_match_jax(name):
    """DCNv2's other structures, EDCN's four bridges and its gates switched off, FiBiNet's other bilinear types."""
    check_forward(name)


def flax_names(name):
    """The flax model's parameter tree of a configuration, as zeros of its shapes (nothing compiles)."""
    jmodel = build(jranking, jfeat, name)
    shapes = jax.eval_shape(lambda batch: jmodel.init(jax.random.PRNGKey(0), batch, training=False), jax_batch(frame(name, 8)[0]))["params"]
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def test_zoo_keeps_flax_names():
    """The parameter names the carrier relies on: EDCN's creation-order module names, the bridges'
    Dense names, CrossNetMix's stacked experts, DeepFFM's two collections, AutoInt's per-feature Dense."""
    assert sorted(flax_names("EDCN")) == ["CrossLayer_0", "CrossLayer_1", "EmbeddingCollection_0", "LR_0", "MLP_0", "MLP_1", "RegulationModule_0", "RegulationModule_1"]
    assert build(tranking, tfeat, "EDCN").MLP_0.Dense_0.weight.shape == (40, 40)  # the MLP is forced to (ΣD, ΣD): 5 fields of 8
    assert set(flax_names("EDCN:attention_pooling")["BridgeModule_2"]) == {"attention_x_1", "attention_x_2", "attention_h_1", "attention_h_2"}
    assert set(flax_names("EDCN:concatenation")["BridgeModule_0"]) == {"Dense_0"}
    assert set(flax_names("DCNv2")["CrossNetMix_0"]) == {"gate_w", "u_0", "v_0", "c_0", "b_0", "u_1", "v_1", "c_1", "b_1"}
    mix = build(tranking, tfeat, "DCNv2").CrossNetMix_0
    assert mix.u_0.shape == (2, 45, 4) and mix.c_1.shape == (2, 4, 4)
    assert set(flax_names("DeepFFM")) == {"linear_embedding", "ffm_embedding", "MLP_0", "b"}
    assert {"dense_I0", "attn_linear", "InteractingLayer_1", "LR_0", "MLP_0"} <= set(flax_names("AutoInt"))
    for name in ZOO + VARIANTS:  # the port's state_dict names are flax's, every one
        assert set(build(tranking, tfeat, name).state_dict()) == set(flax_to_state_dict(flax_names(name))) | bn_buffers(build(tranking, tfeat, name)), name


def bn_buffers(model):
    return {k for k, b in model.named_buffers() if b.is_floating_point()}


def test_afm_attention_is_constant_and_takes_no_gradient():
    """AFM's softmax runs over an axis of size 1: the attention is 1 for every row, so its Dense and
    ``h`` take an exact zero gradient in both packages; the port mirrors the reference."""
    jmodel, variables, model = carried("AFM")
    x, y = frame("AFM", 32, seed=5)

    def jloss(p):
        return jbce(jmodel.apply({"params": p}, jax_batch(x), training=True), jnp.asarray(y))

    jgrads = np_tree(jax.jit(jax.grad(jloss))(variables["params"]))

    model.train()
    bce_with_logits(model({k: torch.from_numpy(v) for k, v in x.items()}), torch.from_numpy(y)).backward()
    for port_grad, ref in ((model.Dense_0.weight.grad, jgrads["Dense_0"]["kernel"]), (model.Dense_0.bias.grad, jgrads["Dense_0"]["bias"]), (model.h.grad, jgrads["h"])):
        assert not port_grad.any() and not np.asarray(ref).any()
    assert model.p.grad.abs().max() > 0 and np.abs(jgrads["p"]).max() > 0  # the projection does learn
    ec = model.EmbeddingCollection_0
    y_fm = model.FM_0(ec({k: torch.from_numpy(v) for k, v in x.items()}, model.fm_features))
    atts = torch.softmax(torch.relu(model.Dense_0(y_fm)) @ model.h, dim=1)
    assert torch.equal(atts, torch.ones_like(atts))
