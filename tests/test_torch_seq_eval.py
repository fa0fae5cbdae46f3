"""The port's serving path (``SeqTrainer.evaluate`` / ``predict_logits``, the
chunked CE, ``SeqLoader``) against the JAX package on carried weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_rechub_tpu.models.generative.hstu import HSTUModel as JHSTUModel
from torch_rechub_tpu.ops import chunked_ce as jce
from torch_rechub_tpu.trainers.seq_trainer import SeqTrainer as JSeqTrainer
from torch_rechub_tpu.trainers.seq_trainer import next_token_loss as jnext_token_loss
from torch_rechub_tpu.utils.data import SeqLoader as JSeqLoader
from torch_rechub_tpu_torch.models.generative.hstu import HSTUModel
from torch_rechub_tpu_torch.ops import chunked_ce as tce
from torch_rechub_tpu_torch.trainers.seq_trainer import SeqTrainer, next_token_loss
from torch_rechub_tpu_torch.utils.data import SeqLoader
from torch_rechub_tpu_torch.utils.jax_weights import load_flax_params

VOCAB, L = 50, 16
MODEL_KW = dict(vocab_size=VOCAB, d_model=32, n_heads=2, n_layers=2, dqk=16, dv=16, max_seq_len=L, dropout=0.0, num_time_buckets=8)
# Losses are means of f32 log-partitions over B*L positions: a few ulps apart
# after the model's 2e-4-relative logit differences (see test_torch_hstu_model.py).
LOSS_RTOL, LOSS_ATOL = 2e-5, 1e-5
LOGIT_RTOL, LOGIT_ATOL = 2e-4, 5e-5
# the chunked LSE against JAX's on the same logits: f32 exp/log/sum in another order
LSE_RTOL, LSE_ATOL = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def seq_data(n=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((n, L), dtype=np.int32)
    for i, length in enumerate(rng.integers(2, L + 1, n)):
        toks[i, :length] = rng.integers(1, VOCAB, length)
    tds = rng.integers(0, 86400, (n, L)).astype(np.int32)
    positions = np.tile(np.arange(L, dtype=np.int32), (n, 1))
    targets = rng.integers(1, VOCAB, n).astype(np.int32)
    return toks, positions, targets, tds


def carried(loss_type, chunk, tmp_path, **model_kw):
    toks, positions, targets, tds = seq_data()
    jloader = JSeqLoader(toks, positions, targets, tds, batch_size=8)
    jtrainer = JSeqTrainer(JHSTUModel(**MODEL_KW, **model_kw), n_epoch=1, loss_type=loss_type, vocab_chunk_size=chunk, model_path=str(tmp_path))
    jtrainer._ensure_ready(jloader)  # initialises the flax params from the first batch
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(jtrainer.state.params))
    model = load_flax_params(HSTUModel(**MODEL_KW, **model_kw), params)
    trainer = SeqTrainer(model, loss_type=loss_type, vocab_chunk_size=chunk, device="cpu")
    return jtrainer, jloader, trainer, SeqLoader(toks, positions, targets, tds, batch_size=8)


@pytest.mark.parametrize("chunk", [None, 16], ids=["dense", "chunked"])
@pytest.mark.parametrize("loss_type", ["cross_entropy", "nce"])
def test_evaluate_and_predict_logits_match_jax(tmp_path, loss_type, chunk):
    jtrainer, jloader, trainer, loader = carried(loss_type, chunk, tmp_path)
    jloss, jacc = jtrainer.evaluate(jloader)
    loss, acc = trainer.evaluate(loader)
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert acc == jacc
    np.testing.assert_allclose(trainer.predict_logits(loader), jtrainer.predict_logits(jloader), rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


def test_evaluate_sampled_softmax_scores_full_vocab_chunked(tmp_path):
    # a sampled-softmax trainer evaluates the exact loss over 8192-wide vocab chunks
    jtrainer, jloader, trainer, loader = carried("sampled_softmax", None, tmp_path, tie_embeddings=False, score_norm="l2", temperature=0.5)
    assert trainer.eval_chunk == 8192
    jloss, jacc = jtrainer.evaluate(jloader)
    loss, acc = trainer.evaluate(loader)
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert acc == jacc


def test_seq_trainer_rejects_unknown_loss():
    with pytest.raises(ValueError, match="loss_type"):
        SeqTrainer(torch.nn.Linear(1, 1), loss_type="bpr", device="cpu")


@pytest.mark.parametrize("chunk_size", [7, 16, 50])
@pytest.mark.parametrize("ignore_index", [0, None])
def test_chunked_logsumexp_matches_jax(chunk_size, ignore_index):
    rng = np.random.default_rng(chunk_size)
    hidden = rng.normal(size=(3, 5, 8)).astype(np.float32)
    weight = rng.normal(size=(VOCAB, 8)).astype(np.float32)
    bias = rng.normal(size=(VOCAB,)).astype(np.float32)
    ref = np.asarray(jce.chunked_logsumexp(jnp.asarray(hidden), jnp.asarray(weight), jnp.asarray(bias), 0.5, ignore_index, chunk_size))
    got = tce.chunked_logsumexp(torch.from_numpy(hidden), torch.from_numpy(weight), torch.from_numpy(bias), 0.5, ignore_index, chunk_size).numpy()
    np.testing.assert_allclose(got, ref, rtol=LSE_RTOL, atol=LSE_ATOL)


@pytest.mark.parametrize("with_bias", [True, False])
def test_chunked_losses_match_jax(with_bias):
    toks, _, targets, _ = seq_data(n=4, seed=3)
    rng = np.random.default_rng(4)
    hidden = rng.normal(size=(4, L, 8)).astype(np.float32)
    weight = rng.normal(size=(VOCAB, 8)).astype(np.float32)
    bias = rng.normal(size=(VOCAB,)).astype(np.float32) if with_bias else None
    j = [jnp.asarray(a) if a is not None else None for a in (hidden, weight, toks, targets, bias)]
    t = [torch.from_numpy(a) if a is not None else None for a in (hidden, weight, toks, targets, bias)]
    ref = float(jce.chunked_next_token_loss(j[0], j[1], j[2], j[3], j[4], 0.7, 0, 16))
    got = float(tce.chunked_next_token_loss(t[0], t[1], t[2], t[3], t[4], 0.7, 0, 16))
    np.testing.assert_allclose(got, ref, rtol=LSE_RTOL, atol=LSE_ATOL)
    ref_last = np.asarray(jce.chunked_last_logits(j[0][:, -1], j[1], j[4], 0.7))
    np.testing.assert_allclose(tce.chunked_last_logits(t[0][:, -1], t[1], t[4], 0.7).numpy(), ref_last, rtol=1e-6, atol=1e-6)
    # the dense next-token loss on the same logits agrees with JAX's and with the chunked one
    logits = rng.normal(size=(4, L, VOCAB)).astype(np.float32)
    ref_dense = float(jnext_token_loss(jnp.asarray(logits), j[2], j[3], 0.7))
    np.testing.assert_allclose(float(next_token_loss(torch.from_numpy(logits), t[2], t[3], 0.7)), ref_dense, rtol=LSE_RTOL, atol=LSE_ATOL)


@pytest.mark.parametrize("shuffle", [False, True])
def test_seq_loader_yields_the_jax_batches(shuffle):
    toks, positions, targets, tds = seq_data(n=21)
    jl = JSeqLoader(toks, positions, targets, tds, batch_size=8, shuffle=shuffle, seed=3)
    tl = SeqLoader(toks, positions, targets, tds, batch_size=8, shuffle=shuffle, seed=3)
    assert len(tl) == len(jl) == 3
    for _ in range(2):  # two epochs: the shuffled order advances alike
        for jb, tb in zip(jl, tl, strict=True):
            for a, b in zip(jb, tb, strict=True):
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        SeqLoader(toks, positions[:3], targets, tds)
