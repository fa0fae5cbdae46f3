"""The pieces of the port's matching path against the JAX package, at small sizes:
``MultiInterestSA`` and ``CapsuleNetwork`` (bilinear types 0, 1 and 2, with and
without ``relu_layer``, type 0's routing start given to both sides: forward and
input gradients); ``softmax_cross_entropy`` and ``bpr_loss`` in every shape
case, weighted and not; the in-batch sampler on a tied score matrix, its
uniform mode on JAX's own keys, the logits it gathers and their loss sums;
the shared flax-style attention with separate query and key/value inputs;
``l2_normalize``; and the data preparation of ``utils/match.py`` and
``utils/data.py`` with numpy's and ``random``'s global generators seeded
alike.  Tolerances: rtol 1e-5, atol 1e-6 on outputs and gradients (fp32 sums
in another order).
"""

import random

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from test_torch_ctr_model import np_tree
from torch_rechub_tpu.basic import layers as jlayers
from torch_rechub_tpu.basic import loss as jloss
from torch_rechub_tpu.basic.layers import torch_linear_init as jtorch_linear_init
from torch_rechub_tpu.models.matching.base import l2_normalize as jl2
from torch_rechub_tpu.utils import data as jdata
from torch_rechub_tpu.utils import match as jmatch
from torch_rechub_tpu_torch.basic import layers as tlayers
from torch_rechub_tpu_torch.basic import loss as tloss
from torch_rechub_tpu_torch.basic.attention import MultiHeadDotProductAttention
from torch_rechub_tpu_torch.models.matching.base import l2_normalize
from torch_rechub_tpu_torch.utils import data as tdata
from torch_rechub_tpu_torch.utils import match as tmatch
from torch_rechub_tpu_torch.utils.jax_weights import load_flax_params

RTOL, ATOL = 1e-5, 1e-6
B, L, D, K = 6, 7, 8, 3


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    mask = (np.arange(L)[None, :] < rng.integers(0, L + 1, B)[:, None]).astype(np.float32)
    mask[1] = 0.0  # an all-PAD row
    return x, mask


def forward_and_input_grad(module, params, x, mask, jcall, tcall):
    """The JAX module's output and ``d sum(out · r) / d x``, and the port's, on the same weights."""
    r = np.random.default_rng(9).normal(size=np.shape(jax.eval_shape(lambda a: jcall(params, a), jnp.asarray(x)))).astype(np.float32)
    ref_out = np.asarray(jax.jit(lambda a: jcall(params, a))(jnp.asarray(x)))
    ref_grad = np.asarray(jax.jit(jax.grad(lambda a: jnp.sum(jcall(params, a) * r)))(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    out = tcall(module, tx)
    (out * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref_out, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tx.grad.numpy(), ref_grad, rtol=RTOL, atol=ATOL)
    return ref_out


@pytest.mark.parametrize("masked", [True, False])
def test_multi_interest_sa_matches_jax(masked):
    x, mask = inputs(1)
    jmod = jlayers.MultiInterestSA(embedding_dim=D, interest_num=K)
    params = np_tree(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask[..., None]))["params"])
    params = {k: (v * 0.3).astype(np.float32) for k, v in params.items()}  # keep tanh off saturation
    module = load_flax_params(tlayers.MultiInterestSA(D, K), params)
    m = mask[..., None] if masked else None
    forward_and_input_grad(module, params, x, mask, lambda p, a: jmod.apply({"params": p}, a, None if m is None else jnp.asarray(m)),
                           lambda mod, a: mod(a, None if m is None else torch.from_numpy(m)))


@pytest.mark.parametrize("bilinear_type,relu_layer", [(0, False), (1, False), (2, False), (0, True), (2, True)])
def test_capsule_network_matches_jax(bilinear_type, relu_layer):
    """Forward and input gradient; only the last routing iteration carries gradients in both packages."""
    x, mask = inputs(2)
    jmod = jlayers.CapsuleNetwork(D, L, bilinear_type=bilinear_type, interest_num=K, relu_layer=relu_layer)
    key = jax.random.PRNGKey(3)
    params = np_tree(jmod.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), jnp.asarray(mask), routing_rng=key)["params"])
    params = jax.tree_util.tree_map(lambda v: (v * 0.3).astype(np.float32), params)
    start = np.array(jax.random.normal(key, (B, K, L)))  # JAX's type-0 routing start, given to the port
    module = load_flax_params(tlayers.CapsuleNetwork(D, L, bilinear_type=bilinear_type, interest_num=K, relu_layer=relu_layer), params)
    out = forward_and_input_grad(module, params, x, mask, lambda p, a: jmod.apply({"params": p}, a, jnp.asarray(mask), routing_rng=key),
                                 lambda mod, a: mod(a, torch.from_numpy(mask), routing_weight=torch.from_numpy(start)))
    assert out.shape == (B, K, D) and np.abs(out[1]).max() == 0.0  # an all-PAD row routes nothing


@pytest.mark.parametrize("weighted", [False, True])
def test_softmax_cross_entropy_matches_jax(weighted):
    rng = np.random.default_rng(4)
    logits, targets = rng.normal(size=(9, 5)).astype(np.float32) * 3, rng.integers(0, 5, 9)
    w = rng.integers(0, 2, 9).astype(np.float32) if weighted else None
    ref = jloss.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(targets), None if w is None else jnp.asarray(w))
    got = tloss.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets), None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["equal_1d", "equal_seq", "neg_1d", "neg_2d"])
@pytest.mark.parametrize("weighted", [False, True])
def test_bpr_loss_matches_jax(case, weighted):
    """The three shape cases: equal shapes element by element (a pair, SASRec's positions, the weight
    broadcast over them), a 1-D ``neg``, a 2-D ``neg`` against ``pos[:, None]``."""
    rng = np.random.default_rng(5)
    shapes = {"equal_1d": ((9,), (9,)), "equal_seq": ((9, 4), (9, 4)), "neg_1d": ((9, 1), (9,)), "neg_2d": ((9,), (9, 3))}[case]
    pos, neg = (rng.normal(size=s).astype(np.float32) * 2 for s in shapes)
    w = rng.integers(0, 2, 9).astype(np.float32) if weighted else None
    if weighted:
        w[0] = 1.0
    ref = jloss.bpr_loss(jnp.asarray(pos), jnp.asarray(neg), None if w is None else jnp.asarray(w))
    got = tloss.bpr_loss(torch.from_numpy(pos), torch.from_numpy(neg), None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL, atol=ATOL)


def test_hard_negatives_break_ties_as_jax():
    """``jax.lax.top_k`` returns equal scores lower index first; the port's sampler takes them the same
    way (a stable descending sort), on a matrix full of ties."""
    rng = np.random.default_rng(6)
    scores = rng.integers(0, 3, (12, 12)).astype(np.float32)
    scores[3] = 1.0  # a row of one value
    for ratio in (1, 4, 11):
        ref = np.asarray(jmatch.inbatch_negative_sampling(jnp.asarray(scores), neg_ratio=ratio, hard_negative=True))
        got = tmatch.inbatch_negative_sampling(torch.from_numpy(scores), neg_ratio=ratio, hard_negative=True)
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(tmatch.gather_inbatch_logits(torch.from_numpy(scores), got).numpy(),
                                      np.asarray(jmatch.gather_inbatch_logits(jnp.asarray(scores), jnp.asarray(ref))))


def test_uniform_negatives_on_jax_keys_match_jax():
    """Uniform sampling is a top-k of U[0, 1) keys with the diagonal masked: given JAX's keys for the same
    rng, the port picks JAX's columns."""
    scores = jnp.zeros((10, 10))
    for seed in range(3):
        rng = jax.random.PRNGKey(seed)
        keys = np.array(jax.random.uniform(rng, (10, 10)))
        ref = np.asarray(jmatch.inbatch_negative_sampling(scores, neg_ratio=4, rng=rng))
        got = tmatch.inbatch_negative_sampling(torch.zeros(10, 10), neg_ratio=4, keys=torch.from_numpy(keys))
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("mode", [1, 2])
def test_inbatch_loss_sums_match_jax(mode):
    rng = np.random.default_rng(7)
    logits, w = rng.normal(size=(8, 5)).astype(np.float32), rng.integers(0, 2, 8).astype(np.float32)
    ref = jmatch.inbatch_loss_from_logits(jnp.asarray(logits), mode, jnp.asarray(w))
    got = tmatch.inbatch_loss_from_logits(torch.from_numpy(logits), mode, torch.from_numpy(w))
    for g, r in zip(got, ref, strict=True):
        np.testing.assert_allclose(float(g), float(r), rtol=RTOL, atol=ATOL)


def test_attention_with_separate_query_and_keys_matches_flax():
    """SASRec attends from ``LayerNorm(h)`` to the un-normed ``h`` under a causal mask: flax's
    ``MultiHeadDotProductAttention(inputs_q, inputs_kv)`` against the shared port module."""
    rng = np.random.default_rng(8)
    q, kv = (rng.normal(size=(4, L, D)).astype(np.float32) for _ in range(2))
    causal = np.tril(np.ones((L, L), bool))[None, None]
    jmha = fnn.MultiHeadDotProductAttention(num_heads=2, kernel_init=jtorch_linear_init, deterministic=True)
    params = np_tree(jmha.init(jax.random.PRNGKey(0), jnp.asarray(q), jnp.asarray(kv), mask=jnp.asarray(causal))["params"])
    params = jax.tree_util.tree_map(lambda a: (a + rng.normal(size=a.shape) * 0.1).astype(np.float32), params)
    ref = np.asarray(jmha.apply({"params": params}, jnp.asarray(q), jnp.asarray(kv), mask=jnp.asarray(causal)))
    mha = load_flax_params(MultiHeadDotProductAttention(D, 2), params).eval()
    got = mha(torch.from_numpy(q), mask=torch.from_numpy(causal), inputs_kv=torch.from_numpy(kv))
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=RTOL, atol=ATOL)
    assert not np.allclose(ref, np.asarray(jmha.apply({"params": params}, jnp.asarray(q), jnp.asarray(q), mask=jnp.asarray(causal))))


def test_l2_normalize_matches_jax():
    x = np.random.default_rng(9).normal(size=(5, 3, 4)).astype(np.float32)
    x[0] = 0.0  # F.normalize's eps: a zero vector stays 0
    for dim in (-1, 1):
        np.testing.assert_allclose(l2_normalize(torch.from_numpy(x), axis=dim).numpy(), np.asarray(jl2(jnp.asarray(x), axis=dim)), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# data preparation, host side
# ---------------------------------------------------------------------------

def interactions(n=300, seed=0):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"user_id": rng.integers(1, 25, n), "item_id": rng.integers(1, 40, n), "time": rng.integers(0, 10000, n), "cate": rng.integers(1, 5, n)})


def seeded(fn, seed=11):
    np.random.seed(seed)
    random.seed(seed)
    return fn()


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_generate_seq_feature_match_and_gen_model_input_match_jax(mode):
    df = interactions()
    kw = dict(item_attribute_cols=["cate"], sample_method=1, mode=mode, neg_ratio=2)
    ref_train, ref_test = seeded(lambda: jmatch.generate_seq_feature_match(df, "user_id", "item_id", "time", **kw))
    train, test = seeded(lambda: tmatch.generate_seq_feature_match(df, "user_id", "item_id", "time", **kw))
    pd.testing.assert_frame_equal(train, ref_train)
    pd.testing.assert_frame_equal(test, ref_test)
    users, items = pd.DataFrame({"user_id": np.arange(25), "age": np.arange(25) % 3}), pd.DataFrame({"item_id": np.arange(40)})
    for padding in ("pre", "post"):
        ref = jmatch.gen_model_input(ref_train, users, "user_id", items, "item_id", seq_max_len=6, padding=padding)
        got = tmatch.gen_model_input(train, users, "user_id", items, "item_id", seq_max_len=6, padding=padding)
        assert list(got) == list(ref)
        for k in ref:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("method", [0, 1, 2, 3])
def test_negative_sample_matches_jax(method):
    counts = {i: int(c) for i, c in zip(range(1, 30), np.random.default_rng(1).integers(1, 50, 29))}
    ratio = 20
    np.testing.assert_array_equal(seeded(lambda: tmatch.negative_sample(counts, ratio, method)), seeded(lambda: jmatch.negative_sample(counts, ratio, method)))
    with pytest.raises(ValueError):
        tmatch.negative_sample(counts, ratio, 4)


def test_data_helpers_match_jax():
    items = list(np.random.default_rng(2).integers(0, 9, 100))
    assert tmatch.get_item_sample_weight(items) == pytest.approx(jmatch.get_item_sample_weight(items))
    seqs = [[1, 2, 3], [], [4, 5, 6, 7, 8, 9, 10], [7]]
    for padding in ("pre", "post"):
        for truncating in ("pre", "post"):
            np.testing.assert_array_equal(tdata.pad_sequences(seqs, maxlen=4, padding=padding, truncating=truncating),
                                          jdata.pad_sequences(seqs, maxlen=4, padding=padding, truncating=truncating))
    np.testing.assert_array_equal(tdata.pad_sequences(seqs), jdata.pad_sequences(seqs))
    df = interactions(20)
    for k, v in tdata.df_to_dict(df).items():
        np.testing.assert_array_equal(v, jdata.df_to_dict(df)[k])
    x, y = {"a": np.arange(10), "b": np.arange(10) * 2}, np.arange(10) % 2
    loaders = tdata.MatchDataGenerator(x, y).generate_dataloader({"a": np.arange(3)}, {"b": np.arange(5)}, batch_size=4)
    ref = jdata.MatchDataGenerator(x, y).generate_dataloader({"a": np.arange(3)}, {"b": np.arange(5)}, batch_size=4)
    for got_loader, ref_loader in zip(loaders, ref, strict=True):
        assert got_loader.shuffle == ref_loader.shuffle and got_loader.batch_size == ref_loader.batch_size and len(got_loader) == len(ref_loader)
