"""The port's ``MTLTrainer`` against the JAX package's, at the sizes of ``tests/test_e2e_multitask.py``
with dropout 0 where the two are compared.

- One step of each aggregation from the same redrawn weights, with
  regularization: the mean (MMOE), UWL, GradNorm, MetaBalance (MMOE) and
  ESMM's sum.  The task losses (rtol 2e-5, atol 1e-5), the gradients and
  every parameter after Adam (``test_torch_cuda_ranking.check_step``), the
  BatchNorm statistics (one update in the step under every method), the
  loss weights (atol 1e-6: UWL's gradient at its zero start, GradNorm's
  closed-form gradient and renormalisation), MetaBalance's norms (rtol
  1e-5, atol 1e-6 of the largest: its step takes no regularization term)
  and ``initial_task_loss`` (0 under MetaBalance, as in JAX).
- A second step after carrying the JAX state (``load_mtl_state``) under
  UWL, GradNorm and MetaBalance; ``loss_weight`` in Adam with weight
  decay, over three steps.
- GradNorm's leaf by flax ``keystr`` for each class; ``is_shared_path`` on the
  JAX test's cases; the closed-form GradNorm gradient and UWL's clamp at 0.
- The sparse path (SGD and Adagrad, mean / UWL / ESMM) against the JAX
  sparse step and the dense table gradient, and its ``ValueError``s.
- ``steps_per_call`` groups equal single steps; a step's per-task gradients
  see the dropout masks of one forward (dropout 0.3).
- ``evaluate`` / ``predict`` against the JAX package's (per-task AUC, NaN for
  a single-class task, MSE for regression) and ``fit`` with early stopping.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ctr_model import np_tree
from test_torch_ctr_train import REG
from test_torch_cuda_mtl import BATCH, MTL_MODELS, OUT_ATOL, OUT_RTOL, TASK_TYPES, build_mtl, mtl_features, mtl_frame, task_types_of
from test_torch_cuda_ranking import LOSS_ATOL, LOSS_RTOL, LR, STATS_ATOL, STATS_RTOL, WD, bn_invariant, check_step
from test_torch_ranking_models import jax_batch, redrawn
from test_torch_sparse_train import TABLE_ATOL, TABLE_RTOL
from torch_rechub_tpu.basic import features as jfeat
from torch_rechub_tpu.models import multi_task as jmt
from torch_rechub_tpu.ops import embedding as jemb
from torch_rechub_tpu.trainers import mtl_trainer as jmtl_trainer
from torch_rechub_tpu.utils import data as jdata
from torch_rechub_tpu.utils import mtl as jmtl
from torch_rechub_tpu_torch.basic import features as tfeat
from torch_rechub_tpu_torch.models import multi_task as tmt
from torch_rechub_tpu_torch.ops import embedding as temb
from torch_rechub_tpu_torch.trainers import MTLTrainer
from torch_rechub_tpu_torch.trainers.mtl_trainer import _aggregate_losses, _task_loss
from torch_rechub_tpu_torch.utils import data as tdata
from torch_rechub_tpu_torch.utils import mtl as tmtl
from torch_rechub_tpu_torch.utils.jax_weights import flax_to_state_dict, load_flax_params, load_mtl_state, tree_leaf_names

OPT = {"lr": LR, "weight_decay": WD}
STEP_CASES = {"mean": ("MMOE", None), "uwl": ("MMOE", "uwl"), "gradnorm": ("MMOE", "gradnorm"), "metabalance": ("MMOE", "metabalance"), "esmm": ("ESMM", None)}
# GradNorm's leaf, the last shared 2-D leaf by sorted flax keystr ('e' of embedding sorts after 'b', 'c')
GRADNORM_LEAVES = {"SharedBottom": "['embedding']['C3_table']", "ESMM": "['embedding']['C3_table']", "MMOE": "['experts_2']['Dense_0']['kernel']",
                   "PLE": "['embedding']['C3_table']", "AITM": "['embedding']['C3_table']"}


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


def adaptive(method):
    return {"method": method} if method else None


def trainer_pair(tmp_path, name, method=None, n=BATCH - 14, seed=1, opt=OPT, **kw):
    """A JAX MTLTrainer and the port's from the same redrawn weights, on ``n`` rows of the configuration."""
    x, ys = mtl_frame(n, seed=seed, esmm=name == "ESMM")
    jtrainer = jmtl_trainer.MTLTrainer(build_mtl(jmt, jfeat, name), task_types_of(name), optimizer_params=opt, adaptive_params=adaptive(method), model_path=str(tmp_path / "jax"), **kw)
    jtrainer._ensure_ready(jdata.ArrayLoader(x, ys, batch_size=BATCH))
    variables = redrawn({"params": np_tree(jtrainer.state.params), "batch_stats": np_tree(jtrainer.state.batch_stats)}, seed=3)
    jtrainer.state = jtrainer.state.replace(params=jax.tree_util.tree_map(jnp.asarray, variables["params"]), batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]))
    model = load_flax_params(build_mtl(tmt, tfeat, name), variables["params"], variables["batch_stats"])
    trainer = MTLTrainer(model, task_types_of(name), optimizer_params=opt, adaptive_params=adaptive(method), model_path=str(tmp_path / "torch"), device="cpu", **kw)
    return jtrainer, trainer, variables, x, ys


def jax_step_grads(jtrainer, variables, x, ys, method):
    """The gradients the JAX step takes, from its own functions: the aggregated loss plus regularization,
    or MetaBalance's scaled / plain sums of the per-task gradients (no regularization)."""
    xp, yp, w = jdata.pad_batch(x, ys, BATCH)
    xb, yb, wb = jax_batch(xp), jnp.asarray(yp), jnp.asarray(w)
    model, types = jtrainer.model, jtrainer.task_types

    def losses(p):
        out, _ = model.apply({"params": p, "batch_stats": variables["batch_stats"]}, xb, training=True, mutable=["batch_stats"])
        return jnp.stack([jmtl_trainer._task_loss(out[:, i], yb[:, i], t, wb) for i, t in enumerate(types)])

    params = variables["params"]
    if method == "metabalance":
        grads_list = [jax.jit(jax.grad(lambda p, i=i: losses(p)[i]))(params) for i in range(jtrainer.n_task)]
        scaled, _ = jmtl.metabalance_scale(grads_list, None, jtrainer.relax_factor, jtrainer.beta)
        plain = jax.tree_util.tree_map(lambda *gs: sum(gs), *grads_list)
        grads = jax.tree_util.tree_map(lambda m, s, q: s if m else q, jmtl.shared_task_mask(params), scaled, plain)
    else:
        def total(p):
            return jmtl_trainer._aggregate_losses(losses(p), jtrainer.state.loss_weight, method, jtrainer.is_esmm) + jtrainer.reg_loss_fn(p)

        grads = jax.jit(jax.grad(total))(params)
    return flax_to_state_dict(np_tree(grads))


@pytest.mark.parametrize("case", STEP_CASES)
def test_mtl_train_step_matches_jax(tmp_path, case):
    name, method = STEP_CASES[case]
    jtrainer, trainer, variables, x, ys = trainer_pair(tmp_path, name, method, regularization_params=REG)
    ref_grads = jax_step_grads(jtrainer, variables, x, ys, method)
    jlosses = jtrainer.train_one_epoch(jdata.ArrayLoader(x, ys, batch_size=BATCH), log_interval=0)
    losses = trainer.train_one_epoch(tdata.ArrayLoader(x, ys, batch_size=BATCH), log_interval=0)
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    before, after = flax_to_state_dict(variables["params"]), flax_to_state_dict(np_tree(jtrainer.state.params))
    named = dict(trainer.model.named_parameters())
    check_step({k: p.grad.numpy() for k, p in named.items()}, {k: p.detach().numpy() for k, p in named.items()},
               {k: v.numpy() for k, v in ref_grads.items()}, {k: v.numpy() for k, v in after.items()}, {k: v.numpy() for k, v in before.items()}, BATCH, ref_grad_noise=True)
    ref_stats = flax_to_state_dict(np_tree(jtrainer.state.batch_stats))
    for key, b in trainer.model.named_buffers():  # one update of the running statistics under every method
        np.testing.assert_allclose(b.numpy(), ref_stats[key].numpy(), rtol=STATS_RTOL, atol=STATS_ATOL, err_msg=key)
    np.testing.assert_allclose(trainer.initial_task_loss.numpy(), np.asarray(jtrainer.state.initial_task_loss), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    if method in ("uwl", "gradnorm"):
        lw = trainer.loss_weight.detach().numpy()
        np.testing.assert_allclose(lw, np.asarray(jtrainer.state.loss_weight), rtol=0, atol=1e-6)
        assert np.abs(lw - (0.0 if method == "uwl" else 1.0)).min() > 0.5 * LR  # the weights moved
        if method == "gradnorm":
            np.testing.assert_allclose(lw.sum(), 2.0, rtol=1e-6)
    if method == "metabalance":
        names = tree_leaf_names(variables["params"])
        assert set(names) == set(trainer.mb_norms)
        largest = max(float(np.asarray(norms).max()) for norms in jtrainer.state.mb_norms)
        for leaf, norms in zip(names, jtrainer.state.mb_norms):  # a bias in front of a BatchNorm: rounding noise
            np.testing.assert_allclose(trainer.mb_norms[leaf].numpy(), np.asarray(norms), rtol=1e-5, atol=1e-6 * largest, err_msg=leaf)


@pytest.mark.parametrize("method", ("uwl", "gradnorm", "metabalance"))
def test_second_step_after_carrying_the_jax_state(tmp_path, method):
    """The JAX trainer's state after one step (parameters, statistics, Adam's moments of the model and the loss
    weights, the loss weights, MetaBalance's moving norms, ``initial_task_loss``, the step) carried into a fresh
    port trainer (``load_mtl_state``), then a second step on another batch on both: the losses, every
    parameter (rtol 1e-5, atol 1e-6; the biases in front of a BatchNorm, whose gradients are rounding noise,
    within 2 lr), the loss weights and norms.  MetaBalance's norms only act from the second step."""
    jtrainer, _, _, x, ys = trainer_pair(tmp_path, "MMOE", method, n=2 * 32)
    first, second = (({k: v[s] for k, v in x.items()}, ys[s]) for s in (slice(0, 32), slice(32, 64)))
    jtrainer.train_one_epoch(jdata.ArrayLoader(*first, batch_size=32), log_interval=0)
    state = jtrainer.state
    (adam,) = [s for s in jax.tree_util.tree_leaves(state.opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")]
    params = np_tree(state.params)
    trainer = MTLTrainer(build_mtl(tmt, tfeat, "MMOE"), TASK_TYPES, optimizer_params=OPT, adaptive_params=adaptive(method), device="cpu")
    load_mtl_state(trainer, params, np_tree(state.batch_stats), np_tree(adam.mu), np_tree(adam.nu), adam.count, loss_weight=None if state.loss_weight is None else np.asarray(state.loss_weight),
                   mb_norms=None if state.mb_norms is None else np_tree(state.mb_norms), initial_task_loss=np.asarray(state.initial_task_loss), step=state.step)
    jlosses = jtrainer.train_one_epoch(jdata.ArrayLoader(*second, batch_size=32), log_interval=0)
    losses = trainer.train_one_epoch(tdata.ArrayLoader(*second, batch_size=32), log_interval=0)
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    ref = flax_to_state_dict(np_tree(jtrainer.state.params))
    invariant = bn_invariant(set(ref))
    for name, p in trainer.model.named_parameters():
        tol = dict(rtol=0, atol=2 * LR) if name in invariant else dict(rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), err_msg=name, **tol)
    if method != "metabalance":
        np.testing.assert_allclose(trainer.loss_weight.detach().numpy(), np.asarray(jtrainer.state.loss_weight), rtol=0, atol=1e-6)
        np.testing.assert_allclose(trainer.initial_task_loss.numpy(), np.asarray(jtrainer.state.initial_task_loss), rtol=1e-6)
    else:
        largest = max(float(np.asarray(v).max()) for v in jtrainer.state.mb_norms)
        for leaf, norms in zip(tree_leaf_names(params), jtrainer.state.mb_norms):
            np.testing.assert_allclose(trainer.mb_norms[leaf].numpy(), np.asarray(norms), rtol=1e-5, atol=1e-6 * largest, err_msg=leaf)


def test_loss_weight_takes_adam_with_weight_decay(tmp_path):
    """UWL's weights over three steps at lr 0.05 and weight decay 0.5 match JAX's, where leaving them
    out of the weight decay would move them by far more than the tolerance."""
    opt = {"lr": 0.05, "weight_decay": 0.5}
    jtrainer, trainer, _, x, ys = trainer_pair(tmp_path, "MMOE", "uwl", n=3 * 32, opt=opt)
    jtrainer.train_one_epoch(jdata.ArrayLoader(x, ys, batch_size=32), log_interval=0)
    trainer.train_one_epoch(tdata.ArrayLoader(x, ys, batch_size=32), log_interval=0)
    ref = np.asarray(jtrainer.state.loss_weight)
    np.testing.assert_allclose(trainer.loss_weight.detach().numpy(), ref, rtol=0, atol=1e-5)
    undecayed = copy.deepcopy(trainer.loss_weight.detach()).zero_().requires_grad_()
    adam = torch.optim.Adam([undecayed], lr=opt["lr"])
    for g in trainer_uwl_grads(tmp_path, x, ys, opt):
        undecayed.grad = g
        adam.step()
    assert np.abs(undecayed.detach().numpy() - ref).max() > 20 * 1e-5


def trainer_uwl_grads(tmp_path, x, ys, opt):
    """The UWL weights' gradients of the three steps, from a port trainer carrying the same weights."""
    _, trainer, _, _, _ = trainer_pair(tmp_path, "MMOE", "uwl", n=3 * 32, opt=opt)
    grads = []
    for xb, yb in tdata.ArrayLoader(x, ys, batch_size=32):
        xb, yb, wb = trainer._to_device(xb, yb.astype(np.float32), np.ones(32, np.float32))
        trainer.train_step(xb, yb, wb)
        grads.append(trainer.loss_weight.grad.clone())
    return grads


@pytest.mark.parametrize("name", MTL_MODELS)
def test_gradnorm_leaf_is_jax_s(tmp_path, name):
    x, ys = mtl_frame(16, esmm=name == "ESMM")
    jtrainer = jmtl_trainer.MTLTrainer(build_mtl(jmt, jfeat, name), task_types_of(name), adaptive_params={"method": "gradnorm"}, model_path=str(tmp_path))
    jtrainer._ensure_ready(jdata.ArrayLoader(x, ys, batch_size=16))
    trainer = MTLTrainer(build_mtl(tmt, tfeat, name), task_types_of(name), adaptive_params={"method": "gradnorm"}, device="cpu")
    leaf = dict(trainer.model.named_parameters())[trainer.gradnorm_leaf]
    assert jtrainer._gradnorm_leaf_path == tmtl.flax_keystr(trainer.gradnorm_leaf, leaf.ndim) == GRADNORM_LEAVES[name]


def test_shared_task_split_follows_flax_paths():
    """``tests/test_e2e_multitask.py:81-90``'s cases, on flax paths and on the port's names."""
    for path, shared in (("['embedding']['C0_table']", True), ("['experts_0']['Dense_0']['kernel']", True), ("['bottom_mlp']['Dense_0']['kernel']", True),
                         ("['towers_0']['Dense_0']['kernel']", False), ("['gates_1']['Dense_0']['kernel']", False), ("['aits_0']['q_layer']['kernel']", False)):
        assert tmtl.is_shared_path(path) == jmtl.is_shared_path(path) == shared, path
    assert tmtl.flax_keystr("aits_0.q_layer.weight", 2) == "['aits_0']['q_layer']['kernel']"
    assert tmtl.flax_keystr("experts_1.BatchNorm_0.weight", 1) == "['experts_1']['BatchNorm_0']['scale']"
    model = build_mtl(tmt, tfeat, "PLE")
    mask = tmtl.shared_task_mask(model.named_parameters())
    assert mask["cgc_layers_0.experts_shared_0.Dense_0.weight"] and mask["embedding.C0_table"]
    assert not mask["cgc_layers_0.gates_specific_1.Dense_0.weight"] and not mask["towers_0.Dense_1.bias"]


def test_gradnorm_weight_grads_and_uwl_clamp_match_jax():
    """GradNorm's closed-form weight gradient against ``jax.grad`` of its loss (a random case, and one where
    every ``|w·n − target|`` is exactly 0, where ``jnp.abs``'s derivative is 1, not ``torch.sign``'s 0); UWL's gradient at the zero start (0.5 of the
    clamp's) and the task loss's at a clip bound, against JAX's."""
    rng = np.random.default_rng(0)
    for norms, w, loss, init in ((rng.uniform(0.1, 2, 3), rng.uniform(0.5, 1.5, 3), rng.uniform(0.2, 1, 3), rng.uniform(0.2, 1, 3)), (np.ones(2), np.ones(2), np.full(2, 0.5), np.full(2, 0.5))):
        args = [np.asarray(a, np.float32) for a in (norms, w, loss, init)]
        ref = np.asarray(jmtl.gradnorm_weight_grads(*(jnp.asarray(a) for a in args), 0.16))
        got = tmtl.gradnorm_weight_grads(*(torch.from_numpy(a) for a in args), 0.16).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got, np.ones(2, np.float32))  # the exact tie
    loss_list = np.asarray([0.7, 0.4], np.float32)
    ref = jax.grad(lambda lw: jmtl_trainer._aggregate_losses(jnp.asarray(loss_list), lw, "uwl", False))(jnp.zeros(2))
    lw = torch.zeros(2, requires_grad=True)
    _aggregate_losses(torch.from_numpy(loss_list), lw, "uwl", False).backward()
    np.testing.assert_allclose(lw.grad.numpy(), np.asarray(ref), rtol=1e-6)
    np.testing.assert_allclose(lw.grad.numpy(), 0.5 - loss_list, rtol=1e-6)
    p = np.asarray([1e-7, 0.3, 1.0 - 1e-7, 1.0], np.float32)
    y, w = np.asarray([1, 0, 1, 0], np.float32), np.ones(4, np.float32)
    ref = jax.grad(lambda q: jmtl_trainer._task_loss(q, jnp.asarray(y), "classification", jnp.asarray(w)))(jnp.asarray(p))
    q = torch.from_numpy(p).requires_grad_()
    _task_loss(q, torch.from_numpy(y), "classification", torch.from_numpy(w)).backward()
    np.testing.assert_allclose(q.grad.numpy(), np.asarray(ref), rtol=1e-6)


SPARSE_CASES = {"sgd": ("MMOE", None, "sgd"), "adagrad_uwl": ("MMOE", "uwl", "adagrad"), "esmm_sgd": ("ESMM", None, "sgd")}


@pytest.mark.parametrize("case", SPARSE_CASES)
def test_sparse_mtl_step_matches_jax(tmp_path, all_fused, case):
    """One sparse step with every table fused (``embedding.fused_d6_table``) at lr 0.05, after
    ``tests/test_sparse_embedding.py:310-355``: the losses, the table (and its accumulator) against JAX's
    sparse step, no dense ``.grad`` on it, the loss weights; under SGD the table equals the table minus lr
    times the dense table gradient of the same loss."""
    name, method, sparse = SPARSE_CASES[case]
    lr = 0.05
    jtrainer, trainer, variables, x, ys = trainer_pair(tmp_path, name, method, opt={"lr": lr}, sparse_embedding=sparse)
    (table_name,) = trainer.sparse_tables
    assert table_name == "embedding.fused_d6_table"
    ref_grads = jax_step_grads(jtrainer, variables, x, ys, method) if sparse == "sgd" else None
    jlosses = jtrainer.train_one_epoch(jdata.ArrayLoader(x, ys, batch_size=BATCH), log_interval=0)
    losses = trainer.train_one_epoch(tdata.ArrayLoader(x, ys, batch_size=BATCH), log_interval=0)
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    table = trainer.sparse_tables[table_name]
    assert table.grad is None
    before, after = flax_to_state_dict(variables["params"])[table_name], flax_to_state_dict(np_tree(jtrainer.state.params))[table_name]
    np.testing.assert_allclose(table.detach().numpy(), after.numpy(), rtol=TABLE_RTOL, atol=TABLE_ATOL)
    assert np.abs(table.detach().numpy() - before.numpy()).max() > 100 * TABLE_ATOL
    if sparse == "sgd":
        np.testing.assert_allclose(table.detach().numpy(), before.numpy() - lr * ref_grads[table_name].numpy(), rtol=TABLE_RTOL, atol=TABLE_ATOL)
    else:
        jaccum = flax_to_state_dict(np_tree(jtrainer.state.opt_state[1]))[table_name].numpy()
        np.testing.assert_allclose(trainer.sparse_accums[table_name].numpy(), jaccum, rtol=TABLE_RTOL, atol=TABLE_ATOL * float(jaccum.max()))
    if method == "uwl":
        np.testing.assert_allclose(trainer.loss_weight.detach().numpy(), np.asarray(jtrainer.state.loss_weight), rtol=0, atol=1e-6)


def test_sparse_path_refuses_gradnorm_metabalance_and_unfused_tables():
    model = build_mtl(tmt, tfeat, "MMOE")
    for method in ("gradnorm", "metabalance"):
        with pytest.raises(ValueError, match=method):
            MTLTrainer(model, TASK_TYPES, adaptive_params={"method": method}, sparse_embedding="adagrad", device="cpu")
    with pytest.raises(ValueError, match="no sparse-capable tables"):  # the default "auto" layout fuses no 30-row table
        MTLTrainer(model, TASK_TYPES, sparse_embedding="sgd", device="cpu")
    with pytest.raises(ValueError, match="unknown adaptive method"):
        MTLTrainer(model, TASK_TYPES, adaptive_params={"method": "pcgrad"}, device="cpu")
    with pytest.raises(ValueError, match="precision"):  # bf16 is ported (tests/test_torch_precision.py)
        MTLTrainer(model, TASK_TYPES, precision="fp8", device="cpu")
    assert MTLTrainer(model, TASK_TYPES, precision="bf16", device="cpu").precision == "bf16"


@pytest.mark.parametrize("method", [None, "uwl", "gradnorm", "metabalance"])
def test_steps_per_call_matches_single_steps(method):
    """``tests/test_e2e_multitask.py::test_steps_per_call_matches_single_step`` in the port: a group of 4
    runs as 4 single steps (parameters and loss weights equal)."""
    x, ys = mtl_frame(128)
    results = []
    for spc in (1, 4):
        model = build_mtl(tmt, tfeat, "MMOE", generator=torch.Generator().manual_seed(0))
        trainer = MTLTrainer(model, TASK_TYPES, adaptive_params=adaptive(method), seed=7, steps_per_call=spc, device="cpu")
        trainer.train_one_epoch(tdata.ArrayLoader(x, ys, batch_size=32), log_interval=0)
        results.append(({k: v.detach().clone() for k, v in model.state_dict().items()}, trainer.loss_weight))
    (a, lw_a), (b, lw_b) = results
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=1e-6, atol=1e-7)
    if method in ("uwl", "gradnorm"):
        torch.testing.assert_close(lw_a, lw_b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("method", ("gradnorm", "metabalance"))
def test_per_task_gradients_see_one_forward_s_dropout_masks(method):
    """At dropout 0.3 the JAX package reuses a step's dropout key in every per-task forward.  The step's
    gradients equal those of separate forwards each drawing from the generator's state at the step's start
    (GradNorm: the weights' gradient from the per-task leaf norms and the model's; MetaBalance: every
    parameter's), and the BatchNorm statistics move once, as after one forward."""
    x, ys = mtl_frame(48, seed=5)
    model = build_mtl(tmt, tfeat, "MMOE", dropout=0.3, generator=torch.Generator().manual_seed(0))
    trainer = MTLTrainer(model, TASK_TYPES, adaptive_params={"method": method}, seed=11, device="cpu")
    xb, yb, wb = trainer._to_device(x, ys, np.ones(48, np.float32))
    start, model0 = trainer.generator.get_state(), copy.deepcopy(model)

    def forward_from_start():
        m = copy.deepcopy(model0).train()
        out = m(xb, generator=torch.Generator().set_state(start))
        return m, trainer.task_losses(out, yb, wb)

    other = copy.deepcopy(model0).train()(xb, generator=torch.Generator().manual_seed(99))
    assert not torch.allclose(forward_from_start()[0](xb, generator=torch.Generator().set_state(start)), other)  # the masks matter
    trainer.train_step(xb, yb, wb)
    names = [n for n, _ in model0.named_parameters()]
    if method == "gradnorm":
        norms = []
        for i in range(2):
            m, losses = forward_from_start()
            norms.append(torch.linalg.vector_norm(torch.autograd.grad(losses[i], dict(m.named_parameters())[trainer.gradnorm_leaf])[0]))
        m, losses = forward_from_start()
        losses.sum().backward()  # Σ L·w at w = 1
        expected = {n: p.grad for n, p in m.named_parameters()}
        w_grad = tmtl.gradnorm_weight_grads(torch.stack(norms), torch.ones(2), losses.detach(), losses.detach(), trainer.alpha)
        torch.testing.assert_close(trainer.loss_weight.grad, w_grad, rtol=1e-6, atol=1e-7)
    else:
        grads_list = []
        for i in range(2):
            m, losses = forward_from_start()
            gs = torch.autograd.grad(losses[i], list(m.parameters()), allow_unused=True)
            grads_list.append({n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(m.named_parameters(), gs)})
        scaled, _ = tmtl.metabalance_scale(grads_list, {n: torch.zeros(2) for n in names})
        expected = {n: scaled[n] if trainer.shared_mask[n] else grads_list[0][n] + grads_list[1][n] for n in names}
    for n, p in model.named_parameters():
        torch.testing.assert_close(p.grad, expected[n], rtol=1e-6, atol=1e-7, msg=n)
    once, _ = forward_from_start()
    for (key, b), ref in zip(model.named_buffers(), once.buffers()):
        torch.testing.assert_close(b, ref, rtol=0, atol=0, msg=key)


@pytest.mark.parametrize("name", MTL_MODELS)
def test_evaluate_predict_and_fit(tmp_path, name):
    """``tests/test_e2e_multitask.py::test_mtl_models_fit`` in the port, on carried weights: ``predict`` and
    ``evaluate`` (per-task AUC) against the JAX package's on 50 rows in batches of 32 (the last padded), then
    ``fit`` with early stopping on task 1: each epoch's scores, the best weights restored, the checkpoint."""
    jtrainer, trainer, _, x, ys = trainer_pair(tmp_path, name, None, n=50, earlystop_taskid=1, earlystop_patience=1, n_epoch=3)
    jpred = np.asarray(jtrainer.predict(jtrainer.model, jdata.ArrayLoader(x, ys, batch_size=32)))
    pred = trainer.predict(trainer.model, tdata.ArrayLoader(x, ys, batch_size=32))
    assert pred.shape == (50, len(task_types_of(name))) and pred.dtype == np.float32
    np.testing.assert_allclose(pred, jpred, rtol=OUT_RTOL, atol=OUT_ATOL)
    np.testing.assert_allclose(trainer.evaluate(trainer.model, tdata.ArrayLoader(x, ys, batch_size=32)),
                               jtrainer.evaluate(jtrainer.model, jdata.ArrayLoader(x, ys, batch_size=32)), rtol=0, atol=1e-12)
    log = trainer.fit(tdata.ArrayLoader(x, ys, batch_size=16, shuffle=True), tdata.ArrayLoader(x, ys, batch_size=16), mode="base", seed=0)
    assert 1 <= len(log) <= 3 and all(len(s) == len(task_types_of(name)) for s in log)
    best = max(s[1] for s in log)
    assert trainer.early_stopper.best_auc == best
    for key, v in trainer.model.state_dict().items():
        torch.testing.assert_close(v, trainer.early_stopper.best_weights[key], rtol=0, atol=0, msg=key)
    assert os.path.exists(tmp_path / "torch" / "model_base_0.pt")


def test_evaluate_scores_single_class_and_regression_tasks_as_jax(tmp_path):
    """A single-class classification task scores NaN; a regression task scores its MSE (carried weights)."""
    types = ("classification", "regression", "classification")
    feats_j, feats_t = mtl_features(jfeat), mtl_features(tfeat)
    towers = ({"dims": (8,)},) * 3
    x, ys = mtl_frame(40, seed=2)
    ys = np.concatenate([ys[:, :1], np.random.default_rng(0).normal(size=(40, 1)).astype(np.float32), np.ones((40, 1), np.float32)], axis=1)
    jtrainer = jmtl_trainer.MTLTrainer(jmt.SharedBottom(features=feats_j, task_types=types, bottom_params={"dims": (16,)}, tower_params_list=towers), types, model_path=str(tmp_path))
    jtrainer._ensure_ready(jdata.ArrayLoader(x, ys, batch_size=16))
    model = load_flax_params(tmt.SharedBottom(features=feats_t, task_types=types, bottom_params={"dims": (16,)}, tower_params_list=towers), np_tree(jtrainer.state.params), np_tree(jtrainer.state.batch_stats))
    trainer = MTLTrainer(model, types, device="cpu")
    ref = jtrainer.evaluate(jtrainer.model, jdata.ArrayLoader(x, ys, batch_size=16))
    got = trainer.evaluate(trainer.model, tdata.ArrayLoader(x, ys, batch_size=16))
    assert np.isnan(got[2]) and np.isnan(ref[2]) and got[1] > 0
    np.testing.assert_allclose(got[:2], ref[:2], rtol=1e-6)
