"""The trainer's step as CUDA graphs on the card (``torch_rechub_tpu_torch/trainers/graph_step.py``), against the
same trainer run eagerly on the card.

These tests need a CUDA device and skip without one.  They import torch and
numpy only:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_graph_step.py

A small HSTU (sampled softmax, dropout, both item tables under row-wise
Adagrad) and a small DeepFM (its large tables fused under row-wise Adagrad,
Adam on the rest) take six steps graphed (a warm-up, a capture, four
replays) and six eagerly: the eager trainer is the same trainer with its
graph path taken away, so both run capturable Adam.  K2's dq and the card's
``index_add_`` add with float atomics, so the two agree to rounding, not
bit for bit: every loss within ``LOSS_REL`` of the eager one, and every
leaf, gradient, accumulator and Adam state within ``STATE_REL`` of its
largest element.  Two eager runs of the HSTU trainer differ by up to 1.0e-6
of a tensor's largest element after six steps on an H100 (the time
buckets' table ``ts_w``, its gradient and Adam's average), so the state is
held to ten times that; a graph that replays the same negatives, skips the
sparse update or keeps a stale learning rate moves it by 1e-3 and more.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_rechub_tpu_torch.basic.features import DenseFeature, SparseFeature
from torch_rechub_tpu_torch.basic.layers import MLP
from torch_rechub_tpu_torch.models.generative.hstu import HSTUModel
from torch_rechub_tpu_torch.models.ranking import DeepFM
from torch_rechub_tpu_torch.ops import chunked_ce
from torch_rechub_tpu_torch.ops import cuda as kernels
from torch_rechub_tpu_torch.trainers import CTRTrainer, SeqTrainer
from torch_rechub_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

LOSS_REL = 1e-6
STATE_REL = 1e-5
STEPS = 6
HSTU_KW = dict(vocab_size=500, d_model=64, n_heads=2, n_layers=2, dqk=32, dv=32, max_seq_len=64, dropout=0.1, num_time_buckets=16, tie_embeddings=False)
GRAPH = ("rechub.train.graph.capture", "rechub.train.graph.replay", "rechub.train.graph.eager", "rechub.train.graph.refused")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    profiling.clear_spans()
    yield torch.device("cuda", torch.cuda.current_device())
    profiling.clear_spans()


@pytest.fixture
def negatives(monkeypatch):
    """The sampled negatives of each trainer's latest step, by its generator: the step copies them into a buffer
    made on its first call, so a replay writes them there as an eager step does."""
    held, real = {}, chunked_ce.sampled_candidates

    def spy(seq_tokens, targets, generator, *args, **kwargs):
        next_tokens, negs = real(seq_tokens, targets, generator, *args, **kwargs)
        if id(generator) not in held:
            held[id(generator)] = torch.empty_like(negs)
        held[id(generator)].copy_(negs)
        return next_tokens, negs

    monkeypatch.setattr(chunked_ce, "sampled_candidates", spy)
    return held


class ReadingSeqTrainer(SeqTrainer):
    """A loss that reads the device from the host: it cannot be captured."""

    def loss_fn(self, *batch):
        loss = super().loss_fn(*batch)
        if not np.isfinite(loss.item()):
            raise FloatingPointError("the loss is not finite")
        return loss


def eager(trainer):
    """The trainer with every step eager on the main stream, its Adam as capturable as the graphed one's."""
    trainer._graphs.step = trainer._eager_step
    return trainer


def hstu_trainer(card, graphed=True, cls=SeqTrainer):
    model = HSTUModel(**HSTU_KW, generator=torch.Generator().manual_seed(5))
    trainer = cls(model, loss_type="sampled_softmax", loss_params={"num_negatives": 64}, sparse_embedding="adagrad", seed=11, device=card)
    return trainer if graphed else eager(trainer)


def hstu_batches(card, n, b=4, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(1, HSTU_KW["vocab_size"], (b, HSTU_KW["max_seq_len"])).astype(np.int64)
        for r, pad in enumerate(rng.integers(0, 50, b)):
            toks[r, :pad] = 0  # left-padded histories of several lengths
        tds = np.where(toks > 0, rng.integers(1, 10**6, toks.shape), 0).astype(np.int32)
        tgts = rng.integers(1, HSTU_KW["vocab_size"], b).astype(np.int64)
        out.append(tuple(torch.from_numpy(a).to(card) for a in (toks, tds, tgts)))
    return out


CARDINALITIES = (300_000, 270_000, 1_000, 2_000, 500, 3_000)  # the two large tables fused (row-wise Adagrad), Adam on the rest


def deepfm_trainer(card, graphed=True):
    sparse = tuple(SparseFeature(f"C{i}", rows, 16) for i, rows in enumerate(CARDINALITIES))
    dense = tuple(DenseFeature(f"I{i}") for i in range(4))
    model = DeepFM(dense, sparse, {"dims": (64, 32), "dropout": 0.1, "activation": "relu"}, generator=torch.Generator().manual_seed(3))
    trainer = CTRTrainer(model, sparse_embedding="adagrad", seed=7, device=card)
    assert trainer.sparse_tables and any(p.ndim == 2 and p.shape[0] == 2_000 for p in (q for g in trainer.optimizer.param_groups for q in g["params"]))
    return trainer if graphed else eager(trainer)


def deepfm_batches(card, n, b=512, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = {f"C{i}": torch.from_numpy(np.minimum(rng.zipf(1.2, b), rows) - 1).to(card) for i, rows in enumerate(CARDINALITIES)}
        x.update({f"I{i}": torch.from_numpy(rng.normal(size=b).astype(np.float32)).to(card) for i in range(4)})
        y = torch.from_numpy((rng.random(b) < 0.25).astype(np.float32)).to(card)
        out.append((x, y, torch.ones(b, device=card)))
    return out


KINDS = {"hstu": (hstu_trainer, hstu_batches), "deepfm": (deepfm_trainer, deepfm_batches)}


def state_of(trainer):
    """Every tensor of the trainer's state by name: leaves, gradients, sparse accumulators, optimizer state."""
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    out = {f"leaf {n}": p.detach() for n, p in trainer.model.named_parameters()}
    out.update({f"grad {n}": p.grad for n, p in trainer.model.named_parameters() if p.grad is not None})
    out.update({f"accumulator {n}": a for n, a in trainer.sparse_accums.items()})
    for opt in getattr(trainer.optimizer, "optimizers", [trainer.optimizer]):
        for p, st in opt.state.items():
            out.update({f"{type(opt).__name__} {names[id(p)]} {k}": v for k, v in st.items() if isinstance(v, torch.Tensor)})
    return out


def worst(a, b):
    """``max |a - b| / max |b|`` (exact where ``b`` is all zeros)."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    scale = float(b.abs().max()) if b.numel() else 0.0
    diff = float((a - b).abs().max()) if b.numel() else 0.0
    return diff if scale == 0.0 else diff / scale


def rounding_only(trainer):
    """The leaves whose gradient is rounding alone: the bias of a Dense layer that feeds a BatchNorm (``MLP``), whose
    mean the BatchNorm takes out again, so that the loss does not move with it.  Adam scales any gradient to a step
    of the learning rate's size, so two runs that round apart (float atomics) move such a leaf apart."""
    layers = [f"{prefix}.Dense_{i}." if prefix else f"Dense_{i}." for prefix, m in trainer.model.named_modules() if isinstance(m, MLP) for i in range(len(m.dims))]
    params = dict(trainer.model.named_parameters())
    for layer in layers:  # the premise: next to its layer's weight gradient, the bias's is rounding
        assert float(params[layer + "bias"].grad.abs().max()) <= 1e-5 * float(params[layer + "weight"].grad.abs().max()), layer
    return {layer + "bias" for layer in layers}


def assert_same_state(graphed, eager):
    got, ref = state_of(graphed), state_of(eager)
    assert got.keys() == ref.keys()
    skip = rounding_only(eager)
    bad = {k: worst(got[k], ref[k]) for k in ref if k.split(" ")[1] not in skip and worst(got[k], ref[k]) > STATE_REL}
    assert not bad, bad
    assert graphed.step == eager.step
    assert torch.equal(graphed.generator.get_state(), eager.generator.get_state())


def run(trainer, batches, negatives=None):
    """``(losses, negatives drawn at each step, launch counts added)`` of one step a batch."""
    before = kernels.launch_counts()
    losses, drawn = [], []
    for b in batches:
        losses.append(trainer.train_step(*b))
        if negatives is not None:
            drawn.append(negatives[id(trainer.generator)].clone())
    after = kernels.launch_counts()
    return losses, drawn, {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}


def graph_counts():
    counts = profiling.counters()
    return tuple(counts.get(name, 0) for name in GRAPH)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_graphed_steps_match_eager_steps(card, negatives, kind):
    build, make = KINDS[kind]
    batches = make(card, STEPS)
    graphed, eager = build(card), build(card, graphed=False)
    negatives = negatives if kind == "hstu" else None
    got = run(graphed, batches[:2], negatives)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # the replays wait for nothing
    try:
        replayed = run(graphed, batches[2:], negatives)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert graph_counts() == (1, STEPS - 1, 1, 0)
    losses, drawn = got[0] + replayed[0], got[1] + replayed[1]
    launches = {k: got[2].get(k, 0) + replayed[2].get(k, 0) for k in got[2].keys() | replayed[2].keys()}
    ref_losses, ref_drawn, ref_launches = run(eager, batches, negatives)
    assert graph_counts() == (1, STEPS - 1, 1, 0)  # the eager trainer counts nothing

    assert len({x.data_ptr() for x in losses}) == STEPS and len({float(x) for x in losses}) == STEPS
    assert all(worst(a, b) <= LOSS_REL for a, b in zip(losses, ref_losses)), [(float(a), float(b)) for a, b in zip(losses, ref_losses)]
    assert_same_state(graphed, eager)
    assert launches == ref_launches
    if kind == "hstu":
        assert launches[("torch_rechub_tpu_torch.ops.cuda.hstu_rab_attention", "launches")] == STEPS * HSTU_KW["n_layers"]
        assert len(drawn) == STEPS and all(torch.equal(a, b) for a, b in zip(drawn, ref_drawn))
        assert len({tuple(d.tolist()) for d in drawn}) == STEPS  # every replay draws anew


def test_a_new_learning_rate_and_a_new_batch_shape_each_capture_a_graph(card, negatives):
    graphed, eager = hstu_trainer(card), hstu_trainer(card, graphed=False)
    plan = [(1e-3, hstu_batches(card, 3, seed=1)), (5e-4, hstu_batches(card, 3, seed=2)), (5e-4, hstu_batches(card, 3, b=3, seed=3)), (1e-3, hstu_batches(card, 2, seed=4))]
    for trainer in (graphed, eager):
        for lr, batches in plan:
            trainer.set_lr(lr)
            run(trainer, batches, negatives)
    # three signatures, each warmed up, captured and replayed; the first lr again replays its held graphs
    assert graph_counts() == (3, 8, 3, 0)
    assert len(graphed._graphs.held) == 3
    assert_same_state(graphed, eager)


def test_loading_a_train_state_drops_the_graphs(card, negatives):
    graphed, eager = hstu_trainer(card), hstu_trainer(card, graphed=False)
    batches = hstu_batches(card, 8, seed=5)
    for trainer in (graphed, eager):
        run(trainer, batches[:3], negatives)
        saved = {k: v for k, v in trainer.train_state().items()}
        saved = torch.utils._pytree.tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, saved)
        run(trainer, batches[3:5], negatives)
        trainer.load_train_state(saved)
        if trainer is graphed:
            assert not graphed._graphs.held
        run(trainer, batches[5:], negatives)
    assert graph_counts() == (2, 6, 2, 0)  # warm-up, capture and replays before the load and after it
    assert graphed.step == 6
    assert_same_state(graphed, eager)


def test_a_loss_that_reads_the_device_stays_eager(card, negatives):
    graphed, eager = (hstu_trainer(card, g, cls=ReadingSeqTrainer) for g in (True, False))
    batches = hstu_batches(card, 4, seed=6)
    losses, _, _ = run(graphed, batches, negatives)
    assert graph_counts() == (0, 0, 4, 1)  # the warm-up, then a refused capture and eager steps
    assert not graphed._graphs.held
    ref_losses, _, _ = run(eager, batches, negatives)
    assert all(worst(a, b) <= LOSS_REL for a, b in zip(losses, ref_losses))
    assert_same_state(graphed, eager)
    torch.rand(4, device=card)  # the default generator draws eagerly again
    torch.cuda.synchronize()


def test_a_replayed_step_opens_the_graph_and_the_sparse_update_spans(card, negatives):
    trainer = hstu_trainer(card)
    batches = hstu_batches(card, 5, seed=7)
    run(trainer, batches[:3], negatives)
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(trainer, batches[3:], negatives)
        torch.cuda.synchronize()
    record = profiling.spans()
    roots = [i for i, s in enumerate(record) if s[0] == "rechub.train_step"]
    assert len(roots) == 2 and all(record[i][1] is None for i in roots)
    for root in roots:
        assert [s[0] for s in record if s[1] == root] == ["rechub.train.graph", "rechub.train.sparse_update"]
    assert not any(s[0] in ("rechub.train.forward", "rechub.train.backward", "rechub.train.optimizer", "rechub.sparse.gather") for s in record)
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert {e.name for e in on_card if getattr(e, "is_user_annotation", False)} >= {"rechub.train.graph", "rechub.train.sparse_update"}
    assert sum(1 for e in on_card if "hstu_rab_fwd" in e.name) == 2 * HSTU_KW["n_layers"]  # the graphs' kernels are traced


def test_a_kernel_switch_between_replays_takes_its_own_kernels(card, negatives):
    """``_FUSED_BWD[0] = False`` for one step between replays: that step runs K2a + K2b, the next replays K2."""
    from torch_rechub_tpu_torch.ops.cuda import hstu_rab_attention as rab

    trainer = hstu_trainer(card)
    batches = hstu_batches(card, 5, seed=8)
    run(trainer, batches[:3], negatives)
    rab._FUSED_BWD[0] = False
    try:
        _, _, split = run(trainer, batches[3:4], negatives)
    finally:
        rab._FUSED_BWD[0] = True
    _, _, fused = run(trainer, batches[4:], negatives)
    layers, name = HSTU_KW["n_layers"], rab.__name__
    assert split == {(name, "launches"): layers, (name, "launches_bwd_dq"): layers, (name, "launches_bwd_dkv"): layers}
    assert fused == {(name, "launches"): layers, (name, "launches_bwd"): layers}
    assert graph_counts() == (1, 3, 2, 0)  # the split step is its signature's warm-up; the fused one replays again
