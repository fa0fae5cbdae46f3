"""HLLM and TIGER on the card against the port on the CPU, and the models and data the CPU parity tests share.

The card tests need a CUDA device and skip without one.  This module
imports torch and numpy only, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_generative.py

HLLM (``tests/test_hllm.py``'s widths, dropout 0): the logits and one
``SeqTrainer`` step under the dense CE, the chunked CE and the sampled
softmax on given negatives (the loss, gradients, parameters after Adam,
the frozen table unmoved).  TIGER (``tests/test_tiger.py``'s widths): the
loss and logits, one ``torch.optim.AdamW`` step, and ``generate``'s beams
with and without a trie.  The card against the CPU from the same seeded
weights.  No kernel of the port's own lies on these paths.
"""

import numpy as np
import pytest
import torch

from test_torch_cuda_ranking import LOSS_ATOL, LOSS_RTOL, check_step, ratio
from torch_rechub_tpu_torch.models.generative.hllm import HLLMModel
from torch_rechub_tpu_torch.models.generative.tiger import TIGERModel, generate
from torch_rechub_tpu_torch.ops import chunked_ce as tce
from torch_rechub_tpu_torch.trainers import SeqTrainer
from torch_rechub_tpu_torch.utils.data import SeqLoader
from torch_rechub_tpu_torch.utils.tiger import Trie

# tests/test_hllm.py:9-14
VOCAB, L, D = 40, 12, 16
HLLM_KW = dict(vocab_size=VOCAB, d_model=D, n_heads=2, n_layers=2, max_seq_len=L, dropout=0.0, num_time_buckets=16)
# tests/test_tiger.py:11,34 (two decoder layers, so that a layer's output feeds another's cross-attention)
TIGER_VOCAB, TIGER_IN, TIGER_LABELS = 30, 10, 4
TIGER_KW = dict(vocab_size=TIGER_VOCAB, d_model=32, n_heads=2, n_enc_layers=1, n_dec_layers=2, d_ff=64, dropout=0.0, max_len=16)
# fp32 sums of up to d products and softmaxes in another order on each side; the cosine logits are
# divided by the temperature 0.07
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 2e-5
# optax.adamw(1e-3)'s decoupled decay (examples/generative/run_rqvae_tiger.py:57)
ADAMW_LR, ADAMW_WD = 1e-3, 1e-4


# ---------------------------------------------------------------------------
# models and data, shared with the CPU parity tests
# ---------------------------------------------------------------------------

def item_embeddings(vocab=VOCAB, d=D, seed=0):
    """Clustered stand-ins for LLM item encodings, PAD row 0 (``examples/generative/run_hllm.py:24-31``)."""
    rng = np.random.default_rng(seed)
    n_clusters = max(4, vocab // 16)
    centers = rng.normal(size=(n_clusters, d))
    emb = centers[np.arange(vocab) % n_clusters] + 0.15 * rng.normal(size=(vocab, d))
    emb[0] = 0.0
    return emb.astype(np.float32)


def hllm_data(n, seed=0, l=L, vocab=VOCAB):
    """Left-padded histories of 2..l items with their seconds to the last one, positions, and targets:
    ``(tokens, positions, targets, time_diffs)``, as ``SeqLoader`` takes them."""
    rng = np.random.default_rng(seed)
    toks, tds = np.zeros((n, l), np.int32), np.zeros((n, l), np.int32)
    for i, length in enumerate(rng.integers(2, l + 1, n)):
        toks[i, l - length:] = rng.integers(1, vocab, length)
        tds[i, l - length:] = np.sort(rng.integers(0, 30 * 86400, length))[::-1]
    positions = np.tile(np.arange(l, dtype=np.int32), (n, 1))
    return toks, positions, rng.integers(1, vocab, n).astype(np.int32), tds


def tiger_data(n, seed=0):
    """Post-padded semantic-id inputs ``(n, TIGER_IN)`` of 3..TIGER_IN tokens in 2..V-1, and labels
    ``(n, TIGER_LABELS)`` with a ``-100`` tail on a third of the rows."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, TIGER_IN), np.int32)
    for i, length in enumerate(rng.integers(3, TIGER_IN + 1, n)):
        x[i, :length] = rng.integers(2, TIGER_VOCAB, length)
    labels = rng.integers(2, TIGER_VOCAB, (n, TIGER_LABELS)).astype(np.int32)
    labels[: n // 3, -1] = -100
    return x, labels


TRIE_SEQS = ([5, 6, 7], [5, 6, 8], [5, 9], [9, 10, 11], [12, 13, 7], [12, 14, 8])  # a short branch: [5, 9]


def adamw_first_update(g):
    g = g.astype(np.float64)
    return g / (np.abs(g) + 1e-8)


def check_adamw_step(grads, after, ref_grads, ref_after, before, grad_rtol=2e-4, grad_atol_rel=1e-4):
    """One AdamW step against a reference from the same weights: each gradient within ``grad_rtol`` and
    ``grad_atol_rel`` of the largest, each parameter within 3e-5 · lr of the reference's plus what the first
    update ``lr · g / (|g| + eps)`` makes of the gradients' difference."""
    largest = max(float(np.abs(r).max()) for r in ref_grads.values())
    for name, r in ref_grads.items():
        np.testing.assert_allclose(grads[name], r, rtol=grad_rtol, atol=grad_atol_rel * largest, err_msg=name)
        carried = ADAMW_LR * np.abs(adamw_first_update(grads[name]) - adamw_first_update(r))
        bad = np.abs(after[name] - ref_after[name]) > 3e-5 * ADAMW_LR + 1e-6 * np.abs(ref_after[name]) + carried
        assert not bad.any(), name
        assert not np.array_equal(after[name], before[name]), name


# ---------------------------------------------------------------------------
# the card against the CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def hllm_pair(device, seed=0):
    cpu = HLLMModel(item_embeddings(), **HLLM_KW, generator=torch.Generator().manual_seed(seed))
    dev = HLLMModel(item_embeddings(), **HLLM_KW, device=device)
    dev.load_state_dict({k: v.to(device) for k, v in cpu.state_dict().items()})
    return cpu, dev


@pytest.mark.cuda
def test_hllm_logits_on_the_card_match_the_cpu(card):
    cpu, dev = hllm_pair(card)
    toks, _, _, tds = hllm_data(32, seed=1)
    with torch.no_grad():
        ref = cpu.eval()(torch.from_numpy(toks), torch.from_numpy(tds))
        got = dev.eval()(torch.from_numpy(toks).to(card), torch.from_numpy(tds).to(card)).cpu()
    assert got.shape == (32, L, VOCAB) and torch.isfinite(got).all()
    assert ratio(got, ref, LOGIT_RTOL, LOGIT_ATOL) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("loss_type,chunk", [("cross_entropy", None), ("cross_entropy", 16), ("sampled_softmax", None)], ids=["dense", "chunked", "sampled"])
def test_hllm_train_step_on_the_card_matches_the_cpu(card, monkeypatch, loss_type, chunk):
    """One SeqTrainer step from the same weights; the sampled softmax takes the same given negatives on both
    devices (each device's generator draws its own)."""
    negs = np.random.default_rng(5).integers(1, VOCAB, 24)
    monkeypatch.setattr(tce, "sampled_candidates", lambda toks, tgts, gen, v, s, ignore: (tce.shifted_labels(toks, tgts, ignore), torch.from_numpy(negs).to(toks.device)))
    cpu, dev = hllm_pair(card, seed=2)
    table = cpu.item_embeddings.clone()
    batch = hllm_data(16, seed=3)
    before = {k: v.detach().numpy().copy() for k, v in cpu.named_parameters()}
    params = {"num_negatives": 24} if loss_type == "sampled_softmax" else None
    losses = [SeqTrainer(m, loss_type=loss_type, loss_params=params, vocab_chunk_size=chunk, device=d).train_one_epoch(SeqLoader(*batch, batch_size=16), log_interval=0)
              for m, d in ((cpu, "cpu"), (dev, card))]
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses[1], losses[0], rtol=LOSS_RTOL, atol=LOSS_ATOL)
    named = dict(dev.named_parameters())
    check_step({k: p.grad.cpu().numpy() for k, p in named.items()}, {k: p.detach().cpu().numpy() for k, p in named.items()},
               {k: p.grad.numpy() for k, p in cpu.named_parameters()}, {k: p.detach().numpy() for k, p in cpu.named_parameters()}, before, 16 * L)
    assert torch.equal(dev.item_embeddings.cpu(), table) and torch.equal(cpu.item_embeddings, table)


@pytest.mark.cuda
def test_tiger_step_and_generate_on_the_card_match_the_cpu(card):
    cpu = TIGERModel(**TIGER_KW, generator=torch.Generator().manual_seed(0))
    dev = TIGERModel(**TIGER_KW, device=card)
    dev.load_state_dict({k: v.to(card) for k, v in cpu.state_dict().items()})
    x, labels = tiger_data(32, seed=1)
    before = {k: v.detach().numpy().copy() for k, v in cpu.named_parameters()}
    losses, logits = [], []
    for m, d in ((cpu, "cpu"), (dev, card)):
        opt = torch.optim.AdamW(m.parameters(), lr=ADAMW_LR, weight_decay=ADAMW_WD)
        loss, out = m.train()(torch.from_numpy(x).to(d), labels=torch.from_numpy(labels).to(d))
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        logits.append(out.detach().cpu())
    np.testing.assert_allclose(losses[1], losses[0], rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert ratio(logits[1], logits[0], LOGIT_RTOL, LOGIT_ATOL) <= 1.0
    named = dict(dev.named_parameters())
    check_adamw_step({k: p.grad.cpu().numpy() for k, p in named.items()}, {k: p.detach().cpu().numpy() for k, p in named.items()},
                     {k: p.grad.numpy() for k, p in cpu.named_parameters()}, {k: p.detach().numpy() for k, p in cpu.named_parameters()}, before)
    for trie, beams in ((None, 1), (None, 3), (Trie(TRIE_SEQS), 3)):
        ref, got = generate(cpu, x[:8], 3, beams, trie, device="cpu"), generate(dev, x[:8], 3, beams, trie, device=card)
        assert got == ref, (trie is not None, beams)
