"""The port's HSTU layers and model against the JAX package on carried weights.

Flax initialises the weights; ``utils/jax_weights.py`` carries them into the
port; both packages run the same numpy inputs in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_rechub_tpu.basic.hstu import HSTULayer as JHSTULayer
from torch_rechub_tpu.models.generative.hstu import HSTUModel as JHSTUModel
from torch_rechub_tpu.ops.pallas import hstu_rab_attention as jmod
from torch_rechub_tpu.utils.hstu_utils import RelativeBucketedTimeAndPositionBias as JRab
from torch_rechub_tpu.utils.hstu_utils import apply_vocab_mask as japply_vocab_mask
from torch_rechub_tpu_torch.basic.hstu import HSTULayer
from torch_rechub_tpu_torch.models.generative.hstu import HSTUModel
from torch_rechub_tpu_torch.utils.hstu_utils import RelativeBucketedTimeAndPositionBias, apply_vocab_mask
from torch_rechub_tpu_torch.utils.jax_weights import flax_to_state_dict, load_flax_params

# One layer: the tolerance of the JAX package's fused-vs-einsum layer test
# (test_pallas_hstu_rab.py:95).  The two LayerNorms differ in their variance
# formula (flax E[x^2]-E[x]^2, torch two-pass) and the sums run in another order.
LAYER_RTOL, LAYER_ATOL = 2e-4, 2e-5
# Whole model, two layers plus the vocab projection: the same per-layer error,
# carried through one more residual layer and a d-wide dot product per logit.
MODEL_RTOL, MODEL_ATOL = 2e-4, 5e-5


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def force_interpret():
    jmod._FORCE_INTERPRET[0] = True
    yield
    jmod._FORCE_INTERPRET[0] = False


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


# ---------------------------------------------------------------------------
# (c) HSTULayer, both branches, against the JAX layer running its Pallas kernel
# ---------------------------------------------------------------------------

LAYER_KW = dict(d_model=32, n_heads=2, dqk=16, dv=16, dropout=0.0, max_seq_len=256, num_time_buckets=16)


def layer_inputs():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 256, 32)).astype(np.float32)
    ts = np.sort(rng.integers(0, 10**6, (2, 256)), axis=1).astype(np.int32)
    mask = np.concatenate([np.ones((2, 200)), np.zeros((2, 56))], axis=1).astype(bool)
    return x, ts, mask


@pytest.mark.parametrize("with_time", [True, False])
def test_hstu_layer_matches_jax_kernel_layer(force_interpret, with_time):
    x, ts, mask = layer_inputs()
    ts_j = jnp.asarray(ts) if with_time else None
    jlayer = JHSTULayer(use_fused_kernel=True, **LAYER_KW)
    variables = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x), padding_mask=jnp.asarray(mask), time_diffs=ts_j)
    ref = np.asarray(jlayer.apply(variables, jnp.asarray(x), padding_mask=jnp.asarray(mask), time_diffs=ts_j))
    params = to_numpy_tree(variables["params"])
    ts_t = torch.from_numpy(ts) if with_time else None
    for fused in (True, False):
        layer = load_flax_params(HSTULayer(use_fused_kernel=fused, **LAYER_KW), params).eval()
        with torch.no_grad():
            got = layer(torch.from_numpy(x), padding_mask=torch.from_numpy(mask), time_diffs=ts_t).numpy()
        np.testing.assert_allclose(got, ref, rtol=LAYER_RTOL, atol=LAYER_ATOL, err_msg=f"fused={fused}")


def test_hstu_layer_without_mask_matches_jax():
    x, ts, _ = layer_inputs()
    x, ts = x[:, :96], ts[:, :96]  # ragged length, no padding mask: the JAX layer runs dense
    jlayer = JHSTULayer(use_fused_kernel=True, **LAYER_KW)
    variables = jlayer.init(jax.random.PRNGKey(1), jnp.asarray(x), time_diffs=jnp.asarray(ts))
    ref = np.asarray(jlayer.apply(variables, jnp.asarray(x), time_diffs=jnp.asarray(ts)))
    layer = load_flax_params(HSTULayer(**LAYER_KW), to_numpy_tree(variables["params"])).eval()
    with torch.no_grad():
        got = layer(torch.from_numpy(x), time_diffs=torch.from_numpy(ts)).numpy()
    np.testing.assert_allclose(got, ref, rtol=LAYER_RTOL, atol=LAYER_ATOL)


def test_rab_dense_bias_matches_jax():
    rng = np.random.default_rng(9)
    ts = rng.integers(0, 10**7, (2, 40)).astype(np.int32)
    jrab = JRab(n_heads=3, max_seq_len=48, num_time_buckets=16)
    variables = jrab.init(jax.random.PRNGKey(2), jnp.asarray(ts))
    rab = RelativeBucketedTimeAndPositionBias(3, 48, 16)
    rab.load_state_dict(flax_to_state_dict(to_numpy_tree(variables["params"])))
    with torch.no_grad():
        for td, seq_len in ((ts, None), (None, 40)):
            ref = np.asarray(jrab.apply(variables, None if td is None else jnp.asarray(td), seq_len=seq_len))
            got = rab(None if td is None else torch.from_numpy(td), seq_len=seq_len).numpy()
            np.testing.assert_array_equal(got, ref)  # gathers and one f32 add: exact
        with pytest.raises(ValueError, match="max_seq_len"):
            rab(seq_len=49)


def test_flax_kernel_is_transposed_into_linear_weight():
    params = {"proj1": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3), "bias": np.zeros(3, np.float32)}, "norm_in": {"scale": np.ones(2, np.float32)}, "layer_3": {"w": np.zeros(1, np.float32)}}
    sd = flax_to_state_dict(params)
    assert sorted(sd) == ["layers.3.w", "norm_in.weight", "proj1.bias", "proj1.weight"]
    np.testing.assert_array_equal(sd["proj1.weight"].numpy(), params["proj1"]["kernel"].T)


# ---------------------------------------------------------------------------
# (d) HSTUModel logits and return_hidden on carried weights
# ---------------------------------------------------------------------------

VOCAB = 64
MODEL_KW = dict(vocab_size=VOCAB, d_model=32, n_heads=2, n_layers=2, dqk=16, dv=16, dropout=0.0, num_time_buckets=8)


def seq_batch(n, l, seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((n, l), dtype=np.int32)
    for i, length in enumerate(rng.integers(2, l + 1, n)):
        toks[i, l - length:] = rng.integers(1, VOCAB, length)  # left padding
    tds = np.sort(rng.integers(0, 10**6, (n, l)), axis=1).astype(np.int32)
    return toks, tds


def carried_models(l, seed=0, **kw):
    toks, tds = seq_batch(4, l, seed)
    jmodel = JHSTUModel(max_seq_len=l, **MODEL_KW, **kw)
    variables = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(toks), jnp.asarray(tds), training=False)
    model = load_flax_params(HSTUModel(max_seq_len=l, **MODEL_KW, **kw), to_numpy_tree(variables["params"])).eval()
    return jmodel, variables, model, toks, tds


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("score_norm", ["none", "l2"])
@pytest.mark.parametrize("with_time", [True, False], ids=["time", "no_time"])
def test_hstu_model_matches_jax(tie, score_norm, with_time):
    kw = dict(tie_embeddings=tie, score_norm=score_norm, temperature=0.7 if score_norm == "l2" else 1.0)
    jmodel, variables, model, toks, tds = carried_models(32, seed=int(tie) + 2 * (score_norm == "l2"), **kw)
    tds_j = jnp.asarray(tds) if with_time else None
    tds_t = torch.from_numpy(tds) if with_time else None
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(toks), tds_j, training=False))
    ref_h = jax.tree_util.tree_map(np.asarray, jmodel.apply(variables, jnp.asarray(toks), tds_j, training=False, return_hidden=True))
    with torch.no_grad():
        got = model(torch.from_numpy(toks), tds_t).numpy()
        got_h = model(torch.from_numpy(toks), tds_t, return_hidden=True)
    np.testing.assert_allclose(got, ref, rtol=MODEL_RTOL, atol=MODEL_ATOL)
    np.testing.assert_allclose(got_h["hidden"].detach().numpy(), ref_h["hidden"], rtol=MODEL_RTOL, atol=MODEL_ATOL)
    np.testing.assert_allclose(got_h["weight"].detach().numpy(), ref_h["weight"], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got_h["bias"].detach().numpy(), ref_h["bias"])


def test_hstu_model_through_jax_kernel_matches(force_interpret):
    # L = 128 sends every JAX layer through the Pallas kernel (interpret mode)
    jmodel, variables, model, toks, tds = carried_models(128, seed=5)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(toks), jnp.asarray(tds), training=False))
    with torch.no_grad():
        got = model(torch.from_numpy(toks), torch.from_numpy(tds)).numpy()
    np.testing.assert_allclose(got, ref, rtol=MODEL_RTOL, atol=MODEL_ATOL)


def test_hstu_model_unfused_equals_fused_on_cpu():
    _, variables, model, toks, tds = carried_models(32, seed=6)
    plain = load_flax_params(HSTUModel(max_seq_len=32, use_fused_kernel=False, **MODEL_KW), to_numpy_tree(variables["params"])).eval()
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.from_numpy(toks), torch.from_numpy(tds)).numpy(), plain(torch.from_numpy(toks), torch.from_numpy(tds)).numpy(), rtol=1e-5, atol=1e-6)


def test_hstu_model_guards_and_pad_rows():
    g = torch.Generator().manual_seed(0)
    model = HSTUModel(max_seq_len=16, use_output_bias=False, generator=g, **MODEL_KW).eval()
    assert torch.all(model.token_embedding[0] == 0)
    with pytest.raises(ValueError, match="max_seq_len"):
        model(torch.zeros((2, 20), dtype=torch.int32))
    with pytest.raises(ValueError, match="score_norm"):
        HSTUModel(score_norm="cosine", **MODEL_KW)
    toks, tds = seq_batch(3, 16)
    toks[0] = 0  # an all-PAD row scores zero everywhere
    with torch.no_grad():
        logits = model(torch.from_numpy(toks), torch.from_numpy(tds))
    assert torch.all(logits[0] == 0) and torch.isfinite(logits).all()


def test_seeded_generator_gives_identical_models():
    a = HSTUModel(max_seq_len=16, generator=torch.Generator().manual_seed(3), **MODEL_KW)
    b = HSTUModel(max_seq_len=16, generator=torch.Generator().manual_seed(3), **MODEL_KW)
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name


def test_apply_vocab_mask_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 10)).astype(np.float32)
    invalid = np.array([[1, 2, -1], [9, 12, 3], [0, 0, 5]])
    ref = np.asarray(japply_vocab_mask(jnp.asarray(logits), static_invalid=[0], invalid_ids=jnp.asarray(invalid)))
    got = apply_vocab_mask(torch.from_numpy(logits), static_invalid=[0], invalid_ids=torch.from_numpy(invalid)).numpy()
    np.testing.assert_array_equal(got, ref)
    ref1 = np.asarray(japply_vocab_mask(jnp.asarray(logits), invalid_ids=jnp.asarray([4, 7])))
    np.testing.assert_array_equal(apply_vocab_mask(torch.from_numpy(logits), invalid_ids=[4, 7]).numpy(), ref1)
