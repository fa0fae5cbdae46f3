"""The port's TIGER (``utils/tiger.py``, ``TIGERModel``, ``generate``) against the JAX package on carried weights."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_cuda_generative import ADAMW_LR, ADAMW_WD, TIGER_KW, TIGER_VOCAB, TRIE_SEQS, tiger_data
from torch_rechub_tpu.models.generative import tiger as jtiger
from torch_rechub_tpu.utils import tiger as jutils
from torch_rechub_tpu_torch.models.generative import TIGERModel
from torch_rechub_tpu_torch.models.generative.tiger import generate
from torch_rechub_tpu_torch.utils import tiger as tutils
from torch_rechub_tpu_torch.utils.jax_weights import flax_to_state_dict, load_flax_params

# fp32 sums of up to d_ff products and softmaxes in another order, through 1 + 2 layers
OUT_RTOL, OUT_ATOL = 1e-5, 1e-5
LOSS_RTOL, LOSS_ATOL = 2e-5, 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 2e-4, 1e-4
# AdamW on identical gradients: optax's f32 bias correction against torch's float64 (test_torch_seq_train.py)
ADAM_RTOL, ADAM_UPDATE_TOL = 1e-6, 3e-5


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


class Jitted:
    """The JAX model with ``apply`` under ``jax.jit``, as ``jtiger.generate`` calls it (one compile per decode shape
    instead of one per operation)."""

    def __init__(self, jmodel):
        self.module, self.pad_token_id = jmodel, jmodel.pad_token_id
        self.apply = jax.jit(jmodel.apply, static_argnames="method")
        self.init = jax.jit(jmodel.init)


@functools.lru_cache(maxsize=None)
def jax_model(kw):
    """One configuration's JAX model, its ``apply`` and ``init`` compiled once for every seed."""
    return Jitted(jtiger.TIGERModel(**{**TIGER_KW, **dict(kw)}))


@functools.lru_cache(maxsize=None)
def jax_side(seed, scale, kw):
    x, labels = tiger_data(2)
    jmodel = jax_model(kw)
    params = np_tree(jmodel.init({"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1)}, jnp.asarray(x), labels=jnp.asarray(labels)))["params"]
    params["shared_embedding"] = (params["shared_embedding"] * scale).astype(np.float32)
    return jmodel, params


def carried(seed=0, scale=1.0, **kw):
    """The JAX model (``apply`` jitted), its params (the shared embedding times ``scale``) and the port's model
    carrying them; the JAX side is built once per argument set."""
    jmodel, params = jax_side(seed, scale, tuple(sorted(kw.items())))
    return jmodel, params, load_flax_params(TIGERModel(**{**TIGER_KW, **kw}), params)


def test_trie_vocab_and_samples_match_jax():
    seqs = [[2, 3, 4], [2, 3, 5], [6, 7, 8], [2, 9]]
    jt, tt = jutils.Trie(seqs), tutils.Trie(seqs)
    for prefix in ((), (2,), (2, 3), (2, 3, 4), (9,), (2, 9), (6, 7)):
        assert tt.allowed_next(prefix) == jt.allowed_next(prefix)  # the insertion order, which generate's ties follow
    for seq in ([2, 3, 4], [2, 9], [2, 9, 1], [6], [7]):
        assert (seq in tt) == (seq in jt)
    indices = {i: [f"<a_{i % 3}>", f"<b_{(i * 7) % 5}>", f"<c_{i % 2}>"] for i in range(12)}
    assert tutils.semantic_id_vocab(indices) == jutils.semantic_id_vocab(indices)
    assert tutils.semantic_id_vocab(indices, n_special=3) == jutils.semantic_id_vocab(indices, n_special=3)
    _, item_tokens = tutils.semantic_id_vocab(indices)
    rng = np.random.default_rng(0)
    histories = {u: rng.integers(0, 12, rng.integers(1, 9)).tolist() for u in range(20)}
    for max_his_len in (20, 3):
        assert tutils.build_tiger_samples(histories, item_tokens, max_his_len, 1) == jutils.build_tiger_samples(histories, item_tokens, max_his_len, 1)


def test_encode_decode_forward_and_loss_match_jax():
    """Padded inputs (the mask from ``input_ids != pad``, then a given mask), ``-100`` labels, ``shift_right``,
    the tied head and the ranking loss at a temperature."""
    jmodel, params, model = carried(seed=2, temperature=0.7)
    x, labels = tiger_data(12, seed=3)
    v = {"params": params}
    model.eval()
    tx, tl = torch.from_numpy(x), torch.from_numpy(labels)
    given = (np.arange(x.shape[1])[None, :] < 4).astype(np.int32).repeat(len(x), 0)
    m = jmodel.module

    @jax.jit
    def jax_outputs(x, given, labels):  # every JAX output of the test, compiled once
        enc, mask = m.apply(v, x, method=m.encode)
        dec = m.apply(v, labels, method=m.shift_right)
        loss, logits = m.apply(v, x, labels=labels)
        return dict(enc=enc, mask=mask, enc2=m.apply(v, x, given, method=m.encode)[0], shifted=dec, loss=loss, logits=logits,
                    dec=m.apply(v, dec, enc, mask, method=m.decode))

    j = jax_outputs(jnp.asarray(x), jnp.asarray(given), jnp.asarray(labels))
    enc, mask = model.encode(tx)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j["mask"]))
    np.testing.assert_allclose(enc.detach().numpy(), np.asarray(j["enc"]), rtol=OUT_RTOL, atol=OUT_ATOL)
    np.testing.assert_allclose(model.encode(tx, torch.from_numpy(given))[0].detach().numpy(), np.asarray(j["enc2"]), rtol=OUT_RTOL, atol=OUT_ATOL)

    dec = model.shift_right(tl)
    np.testing.assert_array_equal(dec.numpy(), np.asarray(j["shifted"]))
    jlogits = j["logits"]
    loss, logits = model(tx, labels=tl)
    assert logits.shape == (12, labels.shape[1], TIGER_VOCAB)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=OUT_RTOL, atol=OUT_ATOL)
    np.testing.assert_allclose(float(loss.detach()), float(j["loss"]), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    np.testing.assert_allclose(model.decode(dec, enc, mask).detach().numpy(), np.asarray(j["dec"]), rtol=OUT_RTOL, atol=OUT_ATOL)
    _, given_logits = model(tx, decoder_input_ids=dec)
    assert torch.equal(given_logits, logits)
    all_ignored = np.full_like(labels, -100)  # no label counts: the loss is 0 / max(0, 1)
    assert float(model.ranking_loss(logits.detach(), torch.from_numpy(all_ignored))) == float(jmodel.module.ranking_loss(jlogits, jnp.asarray(all_ignored))) == 0.0
    with pytest.raises(ValueError, match="labels or decoder_input_ids"):
        model(tx)


def test_adamw_step_matches_optax():
    """The loss's gradients against ``jax.value_and_grad``; then ``torch.optim.AdamW(lr=1e-3, weight_decay=1e-4)``
    against ``optax.adamw(1e-3)`` for two steps on identical gradients (decay on every parameter)."""
    jmodel, params, model = carried(seed=4)
    x, labels = tiger_data(16, seed=5)

    def jloss(p):
        return jmodel.apply({"params": p}, jnp.asarray(x), labels=jnp.asarray(labels))[0]

    ref_loss, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    loss, _ = model(torch.from_numpy(x), labels=torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    ref_grads = flax_to_state_dict(np_tree(jgrads))
    named = dict(model.named_parameters())
    assert set(named) == set(ref_grads)
    largest = max(float(r.abs().max()) for r in ref_grads.values())
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL_REL * largest, err_msg=name)

    tx = optax.adamw(ADAMW_LR)

    @jax.jit
    def adamw(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    state = tx.init(params)
    opt = torch.optim.AdamW(model.parameters(), lr=ADAMW_LR, weight_decay=ADAMW_WD)
    grads = jgrads
    for step in (1, 2):
        params, state = adamw(grads, state, params)
        params = np_tree(params)
        for name, g in flax_to_state_dict(np_tree(grads)).items():
            named[name].grad = g
        opt.step()
        for name, ref in flax_to_state_dict(params).items():
            np.testing.assert_allclose(named[name].detach().numpy(), ref.numpy(), rtol=ADAM_RTOL, atol=ADAM_UPDATE_TOL * ADAMW_LR * step, err_msg=name)
        grads = jax.tree_util.tree_map(lambda a: (a * 0.5 + 1e-3).astype(np.float32), np_tree(grads))


def beam_scores(model, x, beams):
    """The sum of log-probabilities of each generated beam (teacher-forced) under the port's model."""
    with torch.no_grad():
        enc, mask = model.encode(torch.from_numpy(x))
        out = []
        for i, seqs in enumerate(beams):
            row = []
            for seq in seqs:
                dec = torch.tensor([[model.pad_token_id] + seq[:-1]])
                logp = torch.log_softmax(model.decode(dec, enc[i:i + 1], mask[i:i + 1]), -1)[0]
                row.append(float(logp[torch.arange(len(seq)), torch.tensor(seq)].sum()))
            out.append(row)
    return out


CASES = {
    "greedy": dict(max_new_tokens=3, num_beams=1),
    "beams": dict(max_new_tokens=3, num_beams=4),
    "trie_greedy": dict(max_new_tokens=3, num_beams=1, trie=TRIE_SEQS),
    "trie_beams": dict(max_new_tokens=3, num_beams=3, trie=TRIE_SEQS),
    # only [12, 14, 8] has a fourth token: a row whose beam ends elsewhere keeps it (beams[i][:1]), one token
    # shorter than a row that goes on, so at the last step it is padded with 0 at the end and its last column read
    "trie_short_branch": dict(max_new_tokens=4, num_beams=1, trie=TRIE_SEQS + ([12, 14, 8, 3],)),
    "eos": dict(max_new_tokens=3, num_beams=3, trie=tuple(s + [1] for s in TRIE_SEQS), eos_token_id=1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_generate_matches_jax(case):
    """Greedy and beam decoding, with and without a trie, on weights whose shared embedding is scaled up so that
    no two candidates' scores lie within rounding of each other: the same beams in the same order."""
    kw = dict(CASES[case])
    jmodel, params, model = carried(seed=6, scale=6.0)
    x, _ = tiger_data(6, seed=7)
    trie = kw.pop("trie", None)
    ref = jtiger.generate(jmodel, {"params": params}, x, trie=None if trie is None else jutils.Trie(trie), **kw)
    got = generate(model, x, trie=None if trie is None else tutils.Trie(trie), device="cpu", **kw)
    assert got == ref
    assert all(1 <= len(beams) <= kw["num_beams"] for beams in got)
    if trie is not None:
        assert all(seq in tutils.Trie(trie) for beams in got for seq in beams)
    scores = beam_scores(model, x, got)
    assert all(row == sorted(row, reverse=True) for row in scores)
    if case == "trie_short_branch":
        assert {len(beams[0]) for beams in got} == {3, 4}


def test_generate_orders_exact_ties_as_jax():
    """A zero shared embedding gives every token the same log-probability, bit for bit on both sides: the trie's
    candidates stay in its insertion order (Python's stable sort) and, without a trie, in ``np.argsort``'s order."""
    jmodel, params, model = carried(seed=8, scale=0.0)
    x, _ = tiger_data(6, seed=7)
    for trie, beams in ((TRIE_SEQS[::-1], 3), (None, 4)):
        ref = jtiger.generate(jmodel, {"params": params}, x, 3, beams, trie=None if trie is None else jutils.Trie(trie))
        assert generate(model, x, 3, beams, trie=None if trie is None else tutils.Trie(trie), device="cpu") == ref


def test_dropout_draws_from_the_given_generator():
    model = TIGERModel(**{**TIGER_KW, "dropout": 0.3}, generator=torch.Generator().manual_seed(0)).train()
    x, labels = (torch.from_numpy(a) for a in tiger_data(8, seed=10))
    state = torch.random.get_rng_state()
    a, b, c = (float(model(x, labels=labels, generator=torch.Generator().manual_seed(s))[0].detach()) for s in (0, 0, 1))
    assert torch.equal(torch.random.get_rng_state(), state) and a == b != c
    assert float(model.eval()(x, labels=labels)[0].detach()) == float(model(x, labels=labels)[0].detach())  # no dropout in eval mode
    was = model.train().training
    generate(model, x[:2].numpy(), 2, device="cpu")
    assert was and model.training  # generate decodes in eval mode and leaves the mode as it found it
