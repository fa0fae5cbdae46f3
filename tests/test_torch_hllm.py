"""The port's HLLM (``RelPosBias``, the block, ``HLLMModel``) and its path through ``SeqTrainer`` against the JAX
package on carried weights, the frozen item table, and ``SequenceDataGenerator``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cuda_generative import HLLM_KW, L, VOCAB, hllm_data, item_embeddings
from torch_rechub_tpu.models.generative.hllm import HLLMModel as JHLLMModel
from torch_rechub_tpu.models.generative.hllm import HLLMTransformerBlock as JBlock
from torch_rechub_tpu.ops import chunked_ce as jce
from torch_rechub_tpu.trainers import base as jbase
from torch_rechub_tpu.trainers.seq_trainer import SeqTrainer as JSeqTrainer
from torch_rechub_tpu.trainers.seq_trainer import next_token_loss as jnext_token_loss
from torch_rechub_tpu.utils import data as jdata
from torch_rechub_tpu.utils.hstu_utils import RelPosBias as JRelPosBias
from torch_rechub_tpu_torch.models.generative import HLLMModel, HLLMTransformerBlock
from torch_rechub_tpu_torch.ops import chunked_ce as tce
from torch_rechub_tpu_torch.trainers.seq_trainer import SeqTrainer
from torch_rechub_tpu_torch.utils import data as tdata
from torch_rechub_tpu_torch.utils.hstu_utils import RelPosBias
from torch_rechub_tpu_torch.utils.jax_weights import flax_to_state_dict, load_flax_params

# fp32 sums of up to d products and softmaxes in another order; the cosine logits are divided by 0.07
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 2e-5
# the block's outputs: LayerNorm, softmax and the 4d-wide FFN in another order
BLOCK_RTOL, BLOCK_ATOL = 1e-5, 1e-6
# one batch's loss and every gradient (the tolerances of test_torch_seq_train.py)
LOSS_RTOL, LOSS_ATOL = 2e-5, 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 2e-4, 1e-4
# Adam on identical gradients (test_torch_seq_train.py: optax's f32 bias correction against torch's float64)
ADAM_RTOL, ADAM_UPDATE_TOL = 1e-6, 3e-5
LOSSES = [("cross_entropy", None), ("cross_entropy", 16), ("nce", None), ("sampled_softmax", None)]


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@functools.lru_cache(maxsize=None)
def jax_model(kw):
    """The JAX model of one configuration and its jitted ``init`` (compiled once for every seed)."""
    jmodel = JHLLMModel(item_embeddings=item_embeddings(), **HLLM_KW, **dict(kw))
    return jmodel, jax.jit(jmodel.init, static_argnames="training")


@functools.lru_cache(maxsize=None)
def jax_side(seed, kw):
    toks, _, _, tds = hllm_data(4)
    jmodel, init = jax_model(kw)
    return jmodel, np_tree(init(jax.random.PRNGKey(seed), jnp.asarray(toks), jnp.asarray(tds), training=False))


@functools.lru_cache(maxsize=None)
def jax_adam_step():
    """The JAX trainers' first Adam step ``(grads, params) -> params``, jitted."""
    tx, lr = jbase.make_optimizer(None)
    return jax.jit(lambda grads, params: jbase.apply_updates(params, tx.update(grads, tx.init(params), params)[0], lr)), lr


def carried(seed=0, **kw):
    """The JAX model, its variables and the port's model carrying them (params and the constants collection); the
    JAX side is built once per argument set."""
    jmodel, variables = jax_side(seed, tuple(sorted(kw.items())))
    model = load_flax_params(HLLMModel(item_embeddings(), **HLLM_KW, **kw), variables["params"], constants=variables["constants"])
    return jmodel, variables, model


@pytest.mark.parametrize("seq_len,max_seq_len", [(12, 12), (7, 12), (64, 64), (40, 100)], ids=["full", "short", "edges64", "short100"])
def test_rel_pos_bias_matches_jax(seq_len, max_seq_len):
    """The buckets ``min(|i-j|, maxL) * 31 // maxL`` at every |i-j| up to L-1, at L = maxL and L < maxL."""
    jmod = JRelPosBias(n_heads=3, max_seq_len=max_seq_len)
    params = np_tree(jmod.init(jax.random.PRNGKey(1), seq_len))["params"]
    mod = load_flax_params(RelPosBias(3, max_seq_len), params)
    got, ref = mod(seq_len).detach().numpy(), np.asarray(jmod.apply({"params": params}, seq_len))
    assert got.shape == ref.shape == (1, 3, seq_len, seq_len)
    np.testing.assert_array_equal(got, ref)
    table = params["rel_pos_bias_table"]
    rel = np.abs(np.arange(seq_len)[None, :] - np.arange(seq_len)[:, None])
    np.testing.assert_array_equal(got[0], table[np.minimum(rel, max_seq_len) * 31 // max_seq_len].transpose(2, 0, 1))
    bound = np.sqrt(1 / 32)
    fresh = RelPosBias(3, max_seq_len, generator=torch.Generator().manual_seed(0)).rel_pos_bias_table
    assert fresh.shape == (32, 3) and float(fresh.detach().abs().max()) <= bound


def test_block_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, L, 16)).astype(np.float32)
    bias = rng.normal(size=(1, 2, L, L)).astype(np.float32)
    jblock = JBlock(d_model=16, n_heads=2, dropout=0.0)
    params = np_tree(jax.jit(jblock.init)(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(bias)))["params"]
    block = load_flax_params(HLLMTransformerBlock(16, 2, 0.0), params).eval()
    japply = jax.jit(jblock.apply)
    for b in (bias, None):
        ref = np.asarray(japply({"params": params}, jnp.asarray(x), None if b is None else jnp.asarray(b)))
        got = block(torch.from_numpy(x), None if b is None else torch.from_numpy(b)).detach().numpy()
        np.testing.assert_allclose(got, ref, rtol=BLOCK_RTOL, atol=BLOCK_ATOL)


@pytest.mark.parametrize("kw", [{}, {"use_rel_pos_bias": False, "use_time_embedding": False}], ids=["default", "no_bias_no_time"])
def test_model_logits_and_hidden_match_jax(kw):
    jmodel, variables, model = carried(seed=3, **kw)
    toks, _, _, tds = hllm_data(8, seed=4)
    model.eval()
    japply = jax.jit(jmodel.apply, static_argnames="return_hidden")
    for td in (tds, None):  # time_diffs=None reads as zeros
        jt, tt = (None, None) if td is None else (jnp.asarray(td), torch.from_numpy(td))
        ref = np.asarray(japply(variables, jnp.asarray(toks), jt))
        got = model(torch.from_numpy(toks), tt).detach().numpy()
        assert got.shape == (8, L, VOCAB) and np.abs(got).max() <= 1 / 0.07 + 1e-3
        np.testing.assert_allclose(got, ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    jout = japply(variables, jnp.asarray(toks), jnp.asarray(tds), return_hidden=True)
    out = model(torch.from_numpy(toks), torch.from_numpy(tds), return_hidden=True)
    assert out["bias"] is None and jout["bias"] is None and out["weight"] is model.item_embeddings
    np.testing.assert_allclose(out["hidden"].detach().numpy(), np.asarray(jout["hidden"]), rtol=BLOCK_RTOL, atol=BLOCK_ATOL)
    np.testing.assert_array_equal(out["weight"].numpy(), np.asarray(jout["weight"]))


def test_frozen_table_is_a_normalised_buffer():
    emb = item_embeddings()
    model = HLLMModel(emb, **HLLM_KW)
    ref = emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-8)
    np.testing.assert_array_equal(model.item_embeddings.numpy(), ref)
    assert "item_embeddings" in model.state_dict() and "item_embeddings" not in dict(model.named_parameters())
    assert not model.item_embeddings.requires_grad and float(model.item_embeddings[0].abs().max()) == 0.0  # PAD row 0 stays 0
    with pytest.raises(ValueError, match="vocab_size"):
        HLLMModel(emb[:-1], **HLLM_KW)
    with pytest.raises(ValueError, match="d_model"):
        HLLMModel(emb[:, :-1], **HLLM_KW)


@pytest.mark.parametrize("loss_type,chunk", LOSSES, ids=["dense", "chunked", "nce", "sampled"])
def test_seq_trainer_step_matches_jax(monkeypatch, loss_type, chunk):
    """One batch's loss and gradients against ``jax.value_and_grad`` of the JAX trainer's loss, then Adam on
    identical gradients against optax's; the frozen table takes no step.  The sampled softmax takes the same
    given negatives on both sides (the two packages draw from different RNGs)."""
    jmodel, variables, model = carried(seed=5)
    params, consts = variables["params"], {"constants": variables["constants"]}
    toks, _, tgts, tds = hllm_data(8, seed=6)
    negs = np.random.default_rng(7).integers(1, VOCAB, 24)
    negs[:3] = tgts[:3]  # accidental hits, masked out of the loss
    monkeypatch.setattr(tce, "sampled_candidates", lambda seq_tokens, targets, gen, v, s, ignore: (tce.shifted_labels(seq_tokens, targets, ignore), torch.from_numpy(negs)))
    trainer = SeqTrainer(model, loss_type=loss_type, vocab_chunk_size=chunk, loss_params={"num_negatives": 24} if loss_type == "sampled_softmax" else None, device="cpu")
    jt, jtds, jtgts = jnp.asarray(toks), jnp.asarray(tds), jnp.asarray(tgts)

    def jloss(p):
        out = jmodel.apply({"params": p, **consts}, jt, jtds, training=True, return_hidden=chunk is not None or loss_type == "sampled_softmax")
        if loss_type == "sampled_softmax":
            next_tokens, _ = jce.sampled_candidates(jt, jtgts, jax.random.PRNGKey(0), VOCAB, 24, 0)
            w, jn = jnp.asarray(out["weight"]), jnp.asarray(negs)
            return jce.sampled_loss_from_rows(out["hidden"], w[next_tokens], w[jn], None, None, next_tokens, jn, VOCAB, trainer.sampled_t, 0, True, True)
        if chunk is not None:
            return jce.chunked_next_token_loss(out["hidden"], out["weight"], jt, jtgts, out["bias"], trainer.chunked_t, 0, chunk)
        return jnext_token_loss(out, jt, jtgts, trainer.temperature, 0)

    ref_loss, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    table = model.item_embeddings.clone()
    model.train()
    trainer.optimizer.zero_grad()
    loss = trainer.loss_fn(*(torch.from_numpy(a) for a in (toks, tds, tgts)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    ref_grads = flax_to_state_dict(np_tree(jgrads))
    named = dict(model.named_parameters())
    assert set(named) == set(ref_grads)
    largest = max(float(r.abs().max()) for r in ref_grads.values())
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL_REL * largest, err_msg=name)

    adam, lr = jax_adam_step()
    after = flax_to_state_dict(np_tree(adam(jgrads, params)))
    for name, p in named.items():
        p.grad = ref_grads[name].clone()
    trainer.optimizer.step()
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), after[name].numpy(), rtol=ADAM_RTOL, atol=ADAM_UPDATE_TOL * lr, err_msg=name)
    assert torch.equal(model.item_embeddings, table)
    stepped = {id(p) for g in trainer.optimizer.param_groups for p in g["params"]}
    assert stepped == {id(p) for p in named.values()} and id(model.item_embeddings) not in stepped


@pytest.mark.parametrize("loss_type,chunk", [("cross_entropy", None), ("sampled_softmax", None)], ids=["dense", "sampled_chunked_eval"])
def test_evaluate_and_predict_logits_match_jax(tmp_path, loss_type, chunk):
    """``evaluate`` (the sampled softmax's over 8192-wide vocab chunks) and ``predict_logits`` against the JAX
    trainer's on the same weights; fit keeps the frozen table where it was."""
    jmodel, variables, model = carried(seed=8)
    toks, pos, tgts, tds = hllm_data(24, seed=9)
    jtrainer = JSeqTrainer(jmodel, n_epoch=1, loss_type=loss_type, vocab_chunk_size=chunk, model_path=str(tmp_path))
    jloader = jdata.SeqLoader(toks, pos, tgts, tds, batch_size=8)
    jtrainer._ensure_ready(jloader)
    jtrainer.state = jtrainer.state.replace(params=jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    trainer = SeqTrainer(model, loss_type=loss_type, vocab_chunk_size=chunk, n_epoch=1, model_path=str(tmp_path), device="cpu")
    loader = tdata.SeqLoader(toks, pos, tgts, tds, batch_size=8)
    jloss, jacc = jtrainer.evaluate(jloader)
    loss, acc = trainer.evaluate(loader)
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert acc == jacc
    np.testing.assert_allclose(trainer.predict_logits(loader), jtrainer.predict_logits(jloader), rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    table = model.item_embeddings.clone()
    trainer.fit(loader)
    assert torch.equal(model.item_embeddings, table) and torch.equal(torch.load(tmp_path / "model.pt", weights_only=True)["item_embeddings"], table)


def test_sparse_embedding_raises_in_both_packages(tmp_path):
    """HLLM has no table a row-wise update could own: the frozen table is no parameter."""
    toks, pos, tgts, tds = hllm_data(8)
    jtrainer = JSeqTrainer(JHLLMModel(item_embeddings=item_embeddings(), **HLLM_KW), sparse_embedding="adagrad", model_path=str(tmp_path))
    with pytest.raises(ValueError, match="no sparse-capable tables"):
        jtrainer._ensure_ready(jdata.SeqLoader(toks, pos, tgts, tds, batch_size=8))
    with pytest.raises(ValueError, match="no sparse-capable tables"):
        SeqTrainer(HLLMModel(item_embeddings(), **HLLM_KW), sparse_embedding="adagrad", device="cpu")


def test_dropout_draws_from_the_trainers_generator():
    toks, _, tgts, tds = hllm_data(8, seed=10)
    batch = [torch.from_numpy(a) for a in (toks, tds, tgts)]

    def trainer(seed):
        model = HLLMModel(item_embeddings(), **{**HLLM_KW, "dropout": 0.3}, generator=torch.Generator().manual_seed(0))
        return SeqTrainer(model, seed=seed, device="cpu")

    trainers = [trainer(s) for s in (0, 0, 1)]
    global_state = torch.random.get_rng_state()
    a, b, c = (float(t.train_step(*batch)) for t in trainers)
    assert torch.equal(torch.random.get_rng_state(), global_state)  # nothing drawn from torch's global RNG
    assert a == b != c


@pytest.mark.parametrize("split_ratio", [None, (0.6, 0.2, 0.2)], ids=["one_loader", "split"])
def test_sequence_data_generator_matches_jax(split_ratio):
    toks, pos, tgts, tds = hllm_data(30, seed=11)
    jloaders = jdata.SequenceDataGenerator(toks, pos, tgts, tds, seed=3).generate_dataloader(batch_size=8, split_ratio=split_ratio)
    loaders = tdata.SequenceDataGenerator(toks, pos, tgts, tds, seed=3).generate_dataloader(batch_size=8, split_ratio=split_ratio)
    assert len(loaders) == len(jloaders) == (1 if split_ratio is None else 3)
    for jl, tl in zip(jloaders, loaders):
        assert tl.shuffle == jl.shuffle
        for _epoch in range(2):
            for jb, tb in zip(jl, tl, strict=True):
                for ja, ta in zip(jb, tb, strict=True):
                    np.testing.assert_array_equal(ta, ja)
    with pytest.raises(ValueError, match="sum to 1.0"):
        tdata.SequenceDataGenerator(toks, pos, tgts, tds).generate_dataloader(split_ratio=(0.5, 0.2, 0.2))
