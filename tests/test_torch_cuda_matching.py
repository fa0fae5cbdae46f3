"""The matching models and retrieval on the card against the port on the CPU,
and the builders the CPU parity tests of matching share.

The card tests need a CUDA device and skip without one.  This module
imports torch and numpy only, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_matching.py

For each configuration (the 13 classes at the sizes of
``tests/test_e2e_matching.py``, dropout 0): the training output in eval and
train mode and both towers, then one ``MatchTrainer`` step in the class's
mode (loss, gradients, parameters after Adam), the card against the CPU
from the same seeded weights; and exact top-k retrieval, the card's scores
and ids against the CPU's.  No kernel of the port's own lies on this path.
"""

import numpy as np
import pytest
import torch

from test_torch_cuda_ranking import LR, WD, card, check_step, ratio  # noqa: F401  (card is a fixture)
from torch_rechub_tpu_torch.basic import features as tfeat
from torch_rechub_tpu_torch.basic import layers as tlayers
from torch_rechub_tpu_torch.models import matching as tmatching
from torch_rechub_tpu_torch.serving import brute_force_topk
from torch_rechub_tpu_torch.trainers import MatchTrainer
from torch_rechub_tpu_torch.utils.data import ArrayLoader

# tests/test_e2e_matching.py:19
N_USERS, N_ITEMS, SEQ_LEN, D = 30, 40, 10, 8
N_NEG = 3
# the 13 classes; ":towers" builds the same weights with an item feature, so the item tower exists
MATCH_MODELS = ("DSSM", "DSSMSENet", "FaceBookDSSM", "YoutubeDNN", "YoutubeSBC", "GRU4Rec", "NARM", "STAMP", "SASRec", "MIND", "ComirecSA", "ComirecDR", "SINE")
TOWER_VARIANTS = {"NARM": "NARM:towers", "STAMP": "STAMP:towers", "SASRec": "SASRec:towers"}
# the training mode of each class: DSSM point-wise, FaceBookDSSM and SASRec pair-wise, the rest list-wise
# (NARM and STAMP over every item of the vocabulary, the label the positive item's id)
MODES = {"DSSM": 0, "DSSMSENet": 0, "FaceBookDSSM": 1, "SASRec": 1}
FULL_SOFTMAX = ("NARM", "STAMP")
# fp32 sums in another order on each side; the recurrences (GRU4Rec, NARM) and the routing iterations carry it
OUT_RTOL, OUT_ATOL = 1e-5, 1e-6
# the card against the CPU: cuBLAS sums a dot product in another order, and that rounding scales with the terms,
# not with the score (NARM's full-softmax scores cancel to near 0), so beside OUT_ATOL 1e-6 of the largest output
OUT_ATOL_REL = 1e-6
LOSS_RTOL, LOSS_ATOL = 2e-5, 1e-5
BATCH = 64


def mode_of(name):
    return MODES.get(name.partition(":")[0], 2)


# ---------------------------------------------------------------------------
# builders: one function for both packages (``matching`` and ``feat`` are
# either package's modules; ``kw`` goes to the port's constructors only)
# ---------------------------------------------------------------------------

def build_match(matching, feat, name, dropout=0.0, **kw):
    """The configurations of ``tests/test_e2e_matching.py`` (and NARM, STAMP, SASRec, SINE at those sizes)."""
    base, _, option = name.partition(":")
    towers = option == "towers"
    user = feat.SparseFeature("user_id", vocab_size=N_USERS, embed_dim=D)
    hist_mean = feat.SequenceFeature("hist_item_id", vocab_size=N_ITEMS, embed_dim=D, pooling="mean", shared_with="item_id")
    hist = feat.SequenceFeature("hist_item_id", vocab_size=N_ITEMS, embed_dim=D, pooling="concat", shared_with="item_id")
    item = feat.SparseFeature("item_id", vocab_size=N_ITEMS, embed_dim=D)
    neg = feat.SequenceFeature("neg_items", vocab_size=N_ITEMS, embed_dim=D, pooling="concat", shared_with="item_id")
    mlp = {"dims": (16, D), "dropout": dropout}
    frame = dict(user_features=(user,), history_features=(hist,), item_features=(item,), neg_item_feature=(neg,))
    if base in ("DSSM", "DSSMSENet"):
        return getattr(matching, base)(user_features=(user, hist_mean), item_features=(item,), user_params=mlp, item_params=mlp, **kw)
    if base == "FaceBookDSSM":
        neg_item = feat.SparseFeature("neg_item", vocab_size=N_ITEMS, embed_dim=D, shared_with="item_id")
        return matching.FaceBookDSSM(user_features=(user, hist_mean), pos_item_features=(item,), neg_item_features=(neg_item,), user_params=mlp, item_params=mlp, **kw)
    if base == "YoutubeDNN":
        return matching.YoutubeDNN(user_features=(user, hist_mean), item_features=(item,), neg_item_feature=(neg,), user_params=mlp, temperature=0.5, **kw)
    if base == "YoutubeSBC":
        return matching.YoutubeSBC(user_features=(user, hist_mean), item_features=(item,), sample_weight_feature=(feat.DenseFeature("sample_weight"),), user_params=mlp, item_params=mlp, batch_size=BATCH, n_neg=N_NEG, **kw)
    if base == "GRU4Rec":
        return matching.GRU4Rec(**frame, user_params={**mlp, "num_layers": 2}, **kw)
    if base == "MIND":
        return matching.MIND(**frame, max_length=SEQ_LEN, **kw)
    if base == "ComirecSA":
        return matching.ComirecSA(**frame, **kw)
    if base == "ComirecDR":
        return matching.ComirecDR(**frame, max_length=SEQ_LEN, **kw)
    if base == "SINE":
        return matching.SINE(history_features=("hist_item_id",), item_features=("item_id",), neg_item_features=("neg_items",), num_items=N_ITEMS, embedding_dim=D, hidden_dim=12, num_concept=6, num_intention=3, seq_max_len=SEQ_LEN, **kw)
    session = feat.SequenceFeature("hist_item_id", vocab_size=N_ITEMS, embed_dim=D, pooling="concat")
    target = feat.SparseFeature("item_id", vocab_size=N_ITEMS, embed_dim=D) if towers else None
    if base == "NARM":
        return matching.NARM(item_history_feature=session, hidden_dim=12, emb_dropout_p=dropout, session_rep_dropout_p=dropout, item_feature=target, **kw)
    if base == "STAMP":
        return matching.STAMP(item_history_feature=session, weight_std=0.5, emb_std=0.5, item_feature=target, **kw)
    seqs = tuple(feat.SequenceFeature(n, vocab_size=N_ITEMS, embed_dim=D, pooling="concat", **({"shared_with": "seq"} if n != "seq" else {})) for n in ("seq", "pos", "neg"))
    target = feat.SparseFeature("item_id", vocab_size=N_ITEMS, embed_dim=D, shared_with="seq") if towers else None
    return matching.SASRec(features=seqs, max_len=SEQ_LEN, dropout_rate=dropout, num_blocks=2, num_heads=2, item_feature=target, **kw)


def match_frame(n, seed=0, all_pad_rows=1):
    """Histories of 1-L post-padded items (the first rows all PAD), users, positives, 3 negatives, SASRec's
    aligned sequences, YoutubeSBC's sample weights; the labels of the mode (0/1 for point-wise, 0 for the
    list-wise column of the positive)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, SEQ_LEN + 1, n)
    lengths[:all_pad_rows] = 0
    valid = np.arange(SEQ_LEN)[None, :] < lengths[:, None]
    hist = np.where(valid, rng.integers(1, N_ITEMS, (n, SEQ_LEN)), 0).astype(np.int32)
    nxt = np.where(valid, rng.integers(1, N_ITEMS, (n, SEQ_LEN)), 0).astype(np.int32)
    x = {"user_id": rng.integers(0, N_USERS, n).astype(np.int32), "hist_item_id": hist, "item_id": rng.integers(1, N_ITEMS, n).astype(np.int32),
         "neg_items": rng.integers(1, N_ITEMS, (n, N_NEG)).astype(np.int32), "neg_item": rng.integers(1, N_ITEMS, n).astype(np.int32),
         "seq": hist, "pos": nxt, "neg": np.where(valid, rng.integers(1, N_ITEMS, (n, SEQ_LEN)), 0).astype(np.int32),
         "sample_weight": rng.uniform(0.05, 1.0, n).astype(np.float32)}
    return x, rng.integers(0, 2, n).astype(np.float32)


def labels(name, x, y):
    """The labels a configuration trains on: mode 0's 0/1, the positive's id for the full-softmax session
    models, else column 0."""
    base = name.partition(":")[0]
    if mode_of(base) == 0:
        return y
    if base in FULL_SOFTMAX:
        return x["item_id"].astype(np.int64)
    return np.zeros(len(y), np.int64)


@torch.no_grad()
def redraw(model, seed, std=0.3):
    """Every embedding table redrawn at N(0, std²): the fresh 1e-4 tables put SINE's concept scores within
    rounding of each other (its top-k then picks other concepts on either side) and every tower near 0."""
    g = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith(("_table", "_embedding", "position_emb")):
            p.copy_(std * torch.randn(p.shape, generator=g))
    return model


# ---------------------------------------------------------------------------
# the card against the CPU
# ---------------------------------------------------------------------------

def pair(name, device, seed=0):
    cpu = redraw(build_match(tmatching, tfeat, name, generator=torch.Generator().manual_seed(seed)), seed)
    dev = build_match(tmatching, tfeat, name, device=device)
    dev.load_state_dict({k: v.to(device) for k, v in cpu.state_dict().items()})
    return cpu, dev


def outputs(model, x, mode=None):
    out = model(x, mode=mode)
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.cuda
@pytest.mark.parametrize("name", MATCH_MODELS)
def test_matching_forward_on_the_card_matches_the_cpu(card, monkeypatch, name):
    """Eval and train outputs and both towers (MIND's routing start given: each device's own generator
    draws another)."""
    given_routing_start(monkeypatch, seed=4)
    x, _ = match_frame(BATCH, seed=1)
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    dx = {k: v.to(card) for k, v in tx.items()}
    cpu, dev = pair(name, card)
    for train in (False, True):
        cpu.train(train), dev.train(train)
        for ref, got in zip(outputs(cpu, tx), outputs(dev, dx), strict=True):
            assert torch.isfinite(got).all()
            assert ratio(got.detach().cpu(), ref.detach(), OUT_RTOL, OUT_ATOL + OUT_ATOL_REL * float(ref.detach().abs().max())) <= 1.0, (train, name)
    cpu, dev = pair(TOWER_VARIANTS.get(name, name), card)
    cpu.eval(), dev.eval()
    for mode in ("user", "item"):
        ref = cpu(tx, mode=mode).detach()
        assert ratio(dev(dx, mode=mode).detach().cpu(), ref, OUT_RTOL, OUT_ATOL + OUT_ATOL_REL * float(ref.abs().max())) <= 1.0, mode


@pytest.mark.cuda
@pytest.mark.parametrize("name", MATCH_MODELS)
def test_matching_train_step_on_the_card_matches_the_cpu(card, monkeypatch, name):
    """One MatchTrainer step in the class's mode on a partial batch padded to 64 (MIND's routing start
    in training given, the same on both)."""
    cpu, dev = pair(name, card, seed=2)
    x, y = match_frame(BATCH - 14, seed=3)
    y = labels(name, x, y)
    before = {k: v.detach().numpy().copy() for k, v in cpu.named_parameters()}
    given_routing_start(monkeypatch, seed=5)
    losses = []
    for m, d in ((cpu, "cpu"), (dev, card)):
        losses.append(MatchTrainer(m, mode=mode_of(name), optimizer_params={"lr": LR, "weight_decay": WD}, device=d).train_one_epoch(ArrayLoader(x, y, batch_size=BATCH), log_interval=0))
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses[1], losses[0], rtol=LOSS_RTOL, atol=LOSS_ATOL)
    named = dict(dev.named_parameters())
    check_step({k: p.grad.cpu().numpy() for k, p in named.items()}, {k: p.detach().cpu().numpy() for k, p in named.items()},
               {k: p.grad.numpy() for k, p in cpu.named_parameters()}, {k: p.detach().numpy() for k, p in cpu.named_parameters()}, before, BATCH)


def given_routing_start(monkeypatch, seed=None, start=None):
    """MIND's routing start (``basic.layers.routing_start``) replaced by ``start``, or a draw from a CPU
    generator seeded ``seed``, moved to the device asked for: the same values on every device and in
    every mode."""
    if start is None:
        start = torch.randn((BATCH, 4, SEQ_LEN), generator=torch.Generator().manual_seed(seed))
    monkeypatch.setattr(tlayers, "routing_start", lambda shape, training, generator, device: torch.as_tensor(start)[: shape[0]].to(device))
    return start


@pytest.mark.cuda
def test_retrieval_on_the_card_matches_the_cpu(card):
    """Exact top-10 of 300 users over 5,000 items: the scores of the returned ids agree, and the ids
    wherever a user's scores are distinct."""
    rng = np.random.default_rng(0)
    users, items = rng.normal(size=(300, 16)).astype(np.float32), rng.normal(size=(5000, 16)).astype(np.float32)
    ids, scores = brute_force_topk(users, items, 10, batch_size=128, device=card)
    ref_ids, ref_scores = brute_force_topk(users, items, 10, device="cpu")
    np.testing.assert_allclose(scores, ref_scores, rtol=1e-5, atol=1e-5)
    exact = users.astype(np.float64) @ items.T.astype(np.float64)
    np.testing.assert_allclose(np.take_along_axis(exact, ids, 1), scores, rtol=1e-5, atol=1e-5)
    distinct = np.all(np.diff(ref_scores, axis=1) < -1e-5, axis=1)
    np.testing.assert_array_equal(ids[distinct], ref_ids[distinct])
