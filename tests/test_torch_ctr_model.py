"""The port's CTR layers, DeepFM, losses and metrics against the JAX package
on carried weights: LR, FM, MLP with flax-semantics BatchNorm (outputs and
``batch_stats``), the activations, DeepFM's logits under the three table
layouts, ``bce_with_logits`` / ``mse_loss``, ``RegularizationLoss`` and
the exact and bucketed AUC."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_rechub_tpu.basic import activation as jact
from torch_rechub_tpu.basic import features as jfeat
from torch_rechub_tpu.basic import layers as jlayers
from torch_rechub_tpu.basic import loss as jloss
from torch_rechub_tpu.basic import metric as jmetric
from torch_rechub_tpu.models.ranking import DeepFM as JDeepFM
from torch_rechub_tpu.ops import embedding as jemb
from torch_rechub_tpu_torch.basic import activation as tact
from torch_rechub_tpu_torch.basic import features as tfeat
from torch_rechub_tpu_torch.basic import layers as tlayers
from torch_rechub_tpu_torch.basic import loss as tloss
from torch_rechub_tpu_torch.basic import metric as tmetric
from torch_rechub_tpu_torch.models.ranking import DeepFM
from torch_rechub_tpu_torch.ops import embedding as temb
from torch_rechub_tpu_torch.utils.jax_weights import flax_to_state_dict, load_flax_params

N_SPARSE, N_DENSE, VOCAB, DIM, BIG = 5, 3, 64, 8, 262144
MLP_PARAMS = {"dims": (16, 8), "dropout": 0.0, "activation": "relu"}
# fp32 products of up to 43 terms and BatchNorm, in another order than XLA's
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 1e-6
# the bucketed AUC against the exact one, at the default 65536 bins
BUCKET_ATOL = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def schema(feat, big=False):
    """(sparse, dense) features of one package; ``big`` adds a table that "auto" fuses."""
    sparse = tuple(feat.SparseFeature(f"C{i}", vocab_size=VOCAB, embed_dim=DIM) for i in range(N_SPARSE))
    if big:
        sparse += (feat.SparseFeature("C_big", vocab_size=BIG, embed_dim=DIM),)
    return sparse, tuple(feat.DenseFeature(f"I{i}") for i in range(N_DENSE))


def ctr_batch(n, seed=0, big=False):
    rng = np.random.default_rng(seed)
    x = {f"C{i}": rng.integers(0, VOCAB, n).astype(np.int32) for i in range(N_SPARSE)}
    if big:
        x["C_big"] = rng.integers(0, BIG, n).astype(np.int32)
    x.update({f"I{i}": rng.normal(size=n).astype(np.float32) for i in range(N_DENSE)})
    return x


def carried_deepfm(big=False, mlp_params=MLP_PARAMS, seed=0):
    """A flax DeepFM (deep: dense + sparse, fm: sparse) and the port's with its variables."""
    (js, jd), (ts, td) = schema(jfeat, big), schema(tfeat, big)
    jmodel = JDeepFM(deep_features=jd + js, fm_features=js, mlp_params=mlp_params)
    jx = {k: jnp.asarray(v) for k, v in ctr_batch(8, big=big).items()}
    variables = np_tree(jmodel.init(jax.random.PRNGKey(seed), jx, training=False))
    variables = {k: variables[k] for k in ("params", "batch_stats")}  # not the sparse-update hooks' collections
    model = load_flax_params(DeepFM(td + ts, ts, mlp_params), variables["params"], variables["batch_stats"])
    return jmodel, variables, model


def assert_stats_match(model, batch_stats):
    ref = flax_to_state_dict(batch_stats)
    buffers = dict(model.named_buffers())
    assert set(buffers) == set(ref)
    for name, r in ref.items():
        np.testing.assert_allclose(buffers[name].numpy(), r.numpy(), rtol=LOGIT_RTOL, atol=LOGIT_ATOL, err_msg=name)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_lr_fm_and_prediction_match_jax():
    rng = np.random.default_rng(1)
    flat = rng.normal(size=(16, 12)).astype(np.float32)
    stack = rng.normal(size=(16, 4, 3)).astype(np.float32)
    for sigmoid in (False, True):
        jlr = jlayers.LR(sigmoid=sigmoid)
        params = np_tree(jlr.init(jax.random.PRNGKey(0), jnp.asarray(flat))["params"])
        lr = load_flax_params(tlayers.LR(12, sigmoid=sigmoid), params)
        np.testing.assert_allclose(lr(torch.from_numpy(flat)).detach().numpy(), np.asarray(jlr.apply({"params": params}, jnp.asarray(flat))), rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    for reduce_sum in (True, False):
        ref = np.asarray(jlayers.FM(reduce_sum=reduce_sum).apply({}, jnp.asarray(stack)))
        np.testing.assert_allclose(tlayers.FM(reduce_sum)(torch.from_numpy(stack)).numpy(), ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    for task in ("classification", "regression"):
        np.testing.assert_allclose(tlayers.prediction(torch.from_numpy(flat), task).numpy(), np.asarray(jlayers.prediction(jnp.asarray(flat), task)), rtol=1e-6)
    with pytest.raises(ValueError, match="task_type"):
        tlayers.prediction(torch.from_numpy(flat), "ranking")


@pytest.mark.parametrize("activation", ["relu", "dice", "prelu", "sigmoid", "softmax", "leakyrelu"])
def test_mlp_matches_jax_in_train_and_eval(activation):
    """Eval logits, train logits and the mutated batch_stats after one train-mode forward;
    dropout 0.  Dice and PReLU carry their flax parameters (``Dice_i/alpha``, ``PReLU_i/slope``)."""
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(32, 12)) * 3.0 + 1.0).astype(np.float32)
    jmlp = jlayers.MLP(dims=(16, 8), activation=activation)
    variables = np_tree(jmlp.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    # move the running statistics off their start so eval uses them
    variables["batch_stats"] = jax.tree_util.tree_map(lambda a: (a + rng.uniform(0.5, 1.5, a.shape)).astype(np.float32), variables["batch_stats"])
    mlp = load_flax_params(tlayers.MLP(12, (16, 8), activation=activation), variables["params"], variables["batch_stats"])
    ref_eval = np.asarray(jmlp.apply(variables, jnp.asarray(x), training=False))
    np.testing.assert_allclose(mlp.eval()(torch.from_numpy(x)).detach().numpy(), ref_eval, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    ref_train, mutated = jmlp.apply(variables, jnp.asarray(x), training=True, mutable=["batch_stats"])
    np.testing.assert_allclose(mlp.train()(torch.from_numpy(x)).detach().numpy(), np.asarray(ref_train), rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    assert_stats_match(mlp, np_tree(mutated["batch_stats"]))


def test_mlp_without_output_layer_and_with_dropout():
    mlp = tlayers.MLP(6, (5, 4), output_layer=False, dropout=0.5, generator=torch.Generator().manual_seed(0))
    assert [n for n, _ in mlp.named_parameters()] == ["Dense_0.weight", "Dense_0.bias", "BatchNorm_0.weight", "BatchNorm_0.bias", "Dense_1.weight", "Dense_1.bias", "BatchNorm_1.weight", "BatchNorm_1.bias"]
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(64, 6)).astype(np.float32))
    a, b, c = (mlp.train()(x, generator=torch.Generator().manual_seed(s)) for s in (0, 0, 1))
    assert a.shape == (64, 4) and torch.equal(a, b) and not torch.equal(a, c)
    assert 0.6 < float((a == 0).float().mean()) < 0.9  # relu zeros half, dropout half the rest
    assert torch.equal(mlp.eval()(x, generator=torch.Generator().manual_seed(0)), mlp.eval()(x))


def test_batchnorm_keeps_the_biased_variance_unlike_batchnorm1d():
    """flax stores ``0.9 * ra + 0.1 * var`` with the biased batch variance; ``nn.BatchNorm1d``
    (momentum 0.1, the same weighting) stores the unbiased one, n/(n-1) larger, and its
    eval outputs then drift from flax's."""
    rng = np.random.default_rng(5)
    n = 8  # small n: the unbiased variance is 8/7 of the biased one
    x = (rng.normal(size=(n, 6)) * 2.0 + 0.5).astype(np.float32)
    jbn = fnn.BatchNorm(momentum=0.9, epsilon=1e-5)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=False)
    ref_out, mutated = jbn.apply(variables, jnp.asarray(x), use_running_average=False, mutable=["batch_stats"])
    ref_var = np.asarray(mutated["batch_stats"]["var"])

    bn = tlayers.BatchNorm(6)
    np.testing.assert_allclose(bn.train()(torch.from_numpy(x)).detach().numpy(), np.asarray(ref_out), rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    np.testing.assert_allclose(bn.var.numpy(), ref_var, rtol=1e-6)
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(mutated["batch_stats"]["mean"]), rtol=1e-6, atol=1e-7)

    torch_bn = torch.nn.BatchNorm1d(6, momentum=0.1, eps=1e-5)
    torch_bn.train()(torch.from_numpy(x))
    assert not np.allclose(torch_bn.running_var.numpy(), ref_var, rtol=1e-3)
    unbiased = 0.9 + (ref_var - 0.9) * n / (n - 1)
    np.testing.assert_allclose(torch_bn.running_var.numpy(), unbiased, rtol=1e-5)
    probe = torch.from_numpy(x[:3])
    ref_eval = np.asarray(jbn.apply({**variables, "batch_stats": mutated["batch_stats"]}, jnp.asarray(x[:3]), use_running_average=True))
    np.testing.assert_allclose(bn.eval()(probe).detach().numpy(), ref_eval, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    assert not np.allclose(torch_bn.eval()(probe).detach().numpy(), ref_eval, rtol=1e-4, atol=1e-5)


def test_batchnorm_clamps_a_negative_variance_at_zero():
    """E[x²] − E[x]² of nearly equal large values rounds below zero in fp32: flax clamps it."""
    x = np.full((4, 3), 1e4, np.float32)
    x[1, 0] += 0.1
    t = torch.from_numpy(x)
    assert float((t[:, 0] ** 2).mean() - t[:, 0].mean() ** 2) < 0
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref_out, mutated = jbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = tlayers.BatchNorm(3)
    out = bn.train()(t)
    assert torch.isfinite(out).all()
    np.testing.assert_array_equal(bn.var.numpy(), np.asarray(mutated["batch_stats"]["var"]))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


@pytest.mark.parametrize("name", ["sigmoid", "relu", "dice", "prelu", "softmax", "leakyrelu"])
def test_activations_match_jax(name):
    x = np.random.default_rng(6).normal(size=(5, 7)).astype(np.float32) * 2
    jfn = jact.activation_layer(name)
    if isinstance(jfn, fnn.Module):
        params = np_tree(jfn.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
        ref = np.asarray(jfn.apply({"params": params}, jnp.asarray(x)))
        fn = load_flax_params(tact.activation_layer(name, torch.Generator().manual_seed(0)), params)
    else:
        ref, fn = np.asarray(jfn(jnp.asarray(x))), tact.activation_layer(name)
    np.testing.assert_allclose(fn(torch.from_numpy(x)).detach().numpy(), ref, rtol=1e-6, atol=1e-7)
    assert tact.activation_layer(torch.tanh) is torch.tanh
    with pytest.raises(NotImplementedError):
        tact.activation_layer("gelu")


# ---------------------------------------------------------------------------
# DeepFM
# ---------------------------------------------------------------------------

@pytest.fixture(params=[True, False, "auto"], ids=["fused", "per_feature", "auto"])
def fused_default(request):
    """Both packages' process-wide table layout, set for the whole test (flax reads it at every apply)."""
    jold, told = jemb.set_fused_default(request.param), temb.set_fused_default(request.param)
    yield request.param
    jemb.set_fused_default(jold)
    temb.set_fused_default(told)


def test_deepfm_matches_jax(fused_default):
    """Eval and train logits and the train forward's batch_stats, with a table that "auto"
    fuses; the parameter and buffer names are flax's."""
    jmodel, variables, model = carried_deepfm(big=True)
    assert {n.split(".")[0] for n, _ in model.named_parameters()} == {"EmbeddingCollection_0", "LR_0", "MLP_0"} == set(variables["params"])
    assert ("fused_d8_table" in variables["params"]["EmbeddingCollection_0"]) == (fused_default is not False)
    x = ctr_batch(40, seed=7, big=True)
    x["C_big"][:3] = BIG - 1
    jx, tx = {k: jnp.asarray(v) for k, v in x.items()}, {k: torch.from_numpy(v) for k, v in x.items()}
    ref_eval = np.asarray(jmodel.apply(variables, jx, training=False))
    got = model.eval()(tx).detach().numpy()
    assert got.shape == (40,)
    np.testing.assert_allclose(got, ref_eval, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    ref_train, mutated = jmodel.apply(variables, jx, training=True, mutable=["batch_stats"])
    np.testing.assert_allclose(model.train()(tx).detach().numpy(), np.asarray(ref_train), rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    assert_stats_match(model, np_tree(mutated["batch_stats"]))


def test_deepfm_of_the_bench_shape():
    """bench.py's DeepFM: the MLP over the dense features only, LR over the flat fm embeddings."""
    (js, jd), (ts, td) = schema(jfeat), schema(tfeat)
    jmodel = JDeepFM(deep_features=jd, fm_features=js, mlp_params={"dims": (16, 8), "dropout": 0.0, "activation": "relu"})
    x = ctr_batch(24, seed=8)
    variables = np_tree(jmodel.init(jax.random.PRNGKey(1), {k: jnp.asarray(v) for k, v in x.items()}))
    variables = {k: variables[k] for k in ("params", "batch_stats")}
    model = load_flax_params(DeepFM(td, ts, {"dims": (16, 8), "dropout": 0.0, "activation": "relu"}), variables["params"], variables["batch_stats"])
    assert model.MLP_0.Dense_0.weight.shape == (16, N_DENSE) and model.LR_0.Dense_0.weight.shape == (1, N_SPARSE * DIM)
    ref = np.asarray(jmodel.apply(variables, {k: jnp.asarray(v) for k, v in x.items()}, training=False))
    np.testing.assert_allclose(model.eval()({k: torch.from_numpy(v) for k, v in x.items()}).detach().numpy(), ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


# ---------------------------------------------------------------------------
# losses, regularization, metrics
# ---------------------------------------------------------------------------

def test_bce_and_mse_match_jax():
    rng = np.random.default_rng(9)
    logits = (rng.normal(size=64) * 10).astype(np.float32)
    logits[:2] = [80.0, -80.0]
    y = rng.integers(0, 2, 64).astype(np.float32)
    for w in (None, (rng.uniform(size=64) > 0.3).astype(np.float32), np.zeros(64, np.float32)):
        jw, tw = (None, None) if w is None else (jnp.asarray(w), torch.from_numpy(w))
        for jfn, tfn in ((jloss.bce_with_logits, tloss.bce_with_logits), (jloss.mse_loss, tloss.mse_loss)):
            ref = float(jfn(jnp.asarray(logits[:, None]), jnp.asarray(y), jw))
            got = float(tfn(torch.from_numpy(logits[:, None]), torch.from_numpy(y), tw))
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_regularization_matches_jax_on_carried_weights():
    _, variables, model = carried_deepfm(big=True)
    reg = {"embedding_l1": 1e-3, "embedding_l2": 2e-3, "dense_l1": 3e-4, "dense_l2": 5e-4}
    got = float(tloss.RegularizationLoss(**reg)(model.named_parameters()).detach())
    ref = float(jloss.RegularizationLoss(**reg)(variables["params"]))
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    # its gradient too, where the L1 term meets the zero-initialised biases: jnp.abs's gradient at 0 is 1
    model.zero_grad()
    tloss.RegularizationLoss(**reg)(model.named_parameters()).backward()
    jgrads = flax_to_state_dict(np_tree(jax.grad(jloss.RegularizationLoss(**reg))(variables["params"])))
    for name, p in model.named_parameters():
        got = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()  # BatchNorm's are exempt
        np.testing.assert_allclose(got, jgrads[name].numpy(), rtol=1e-6, atol=1e-12, err_msg=name)
    assert float(model.LR_0.Dense_0.bias.grad) == np.float32(reg["dense_l1"])
    # the tables and only they are "embedding"; BatchNorm's scale and bias are exempt; as in JAX
    kinds = {name: tloss.classify_param(name) for name, _ in model.named_parameters()}
    assert kinds == {name: "embedding" if name.endswith("_table") else "norm" if "BatchNorm" in name else "dense" for name in kinds}
    jkinds = [jloss.classify_param(jax.tree_util.keystr(path)) for path, _ in jax.tree_util.tree_flatten_with_path(variables["params"])[0]]
    assert sorted(jkinds) == sorted(kinds.values())
    assert not tloss.RegularizationLoss() and float(tloss.RegularizationLoss()(model.named_parameters())) == 0.0


def test_auc_matches_jax():
    rng = np.random.default_rng(10)
    y = rng.integers(0, 2, 2000).astype(np.float32)
    scores = np.round(rng.uniform(size=2000) * 0.5 + 0.3 * y, 3).astype(np.float32)  # ties
    assert tmetric.auc_score(y, scores) == jmetric.auc_score(y, scores)
    with pytest.raises(ValueError, match="single class"):
        tmetric.auc_score(np.ones(4), scores[:4])
    w = (rng.uniform(size=2000) > 0.1).astype(np.float32)
    jpos, jneg = jmetric.auc_histogram(jnp.asarray(y), jnp.asarray(scores), weight=jnp.asarray(w))
    pos, neg = tmetric.auc_histogram(torch.from_numpy(y), torch.from_numpy(scores), weight=torch.from_numpy(w))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(neg.numpy(), np.asarray(jneg))
    exact = tmetric.auc_score(y[w > 0], scores[w > 0])
    assert abs(float(tmetric.auc_from_histogram(pos, neg)) - exact) < BUCKET_ATOL
    np.testing.assert_allclose(float(tmetric.auc_from_histogram(pos, neg)), float(jmetric.auc_from_histogram(jpos, jneg)), rtol=1e-6)
    p = np.clip(scores, 0, 1)
    assert tmetric.log_loss(y, p) == jmetric.log_loss(y, p)
