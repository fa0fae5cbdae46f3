"""The port's spans (``torch_rechub_tpu_torch/utils/profiling.py``): free with no profiler running, nested as
the module docstring says under one, and the same numbers either way.

A trainer's step opens ``rechub.train_step`` and its four stages in order;
the tables' gathers and HSTU's forward sit under the forward stage; the
retrieval's top-k is a span of its own.  Each span shows twice under a
profiler, as a ``record_function`` range among ``prof.events()`` and as an
entry of ``spans()``, and in both each child lies inside its parent.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_rechub_tpu_torch.basic.features import DenseFeature, SparseFeature
from torch_rechub_tpu_torch.models.generative.hstu import HSTUModel
from torch_rechub_tpu_torch.models.ranking import DeepFM
from torch_rechub_tpu_torch.ops.embedding import set_fused_default
from torch_rechub_tpu_torch.serving.retrieval import brute_force_topk
from torch_rechub_tpu_torch.trainers import CTRTrainer, SeqTrainer
from torch_rechub_tpu_torch.utils import profiling

STAGES = ["rechub.train.forward", "rechub.train.backward", "rechub.train.optimizer", "rechub.train.sparse_update"]
VOCAB, L, B = 50, 8, 4


@pytest.fixture(autouse=True)
def empty_record():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def hstu_trainer(seed=0):
    model = HSTUModel(vocab_size=VOCAB, d_model=16, n_heads=2, n_layers=1, dqk=8, dv=8, max_seq_len=L, dropout=0.0, num_time_buckets=8,
                      tie_embeddings=False, generator=torch.Generator().manual_seed(seed))
    return SeqTrainer(model, loss_type="sampled_softmax", loss_params={"num_negatives": 8}, sparse_embedding="adagrad", seed=seed, device="cpu")


def hstu_batch(i):
    rng = np.random.default_rng(100 + i)
    toks = torch.from_numpy(rng.integers(1, VOCAB, (B, L))).to(torch.int32)
    toks[0, :3] = 0  # a left-padded history
    tds = torch.from_numpy(rng.integers(0, 86400, (B, L))).to(torch.int32)
    return toks, tds, torch.from_numpy(rng.integers(1, VOCAB, B)).to(torch.int32)


def deepfm_trainer(seed=0):
    sparse = tuple(SparseFeature(f"C{i}", vocab_size=30 + 10 * i, embed_dim=8) for i in range(3))
    old = set_fused_default(True)
    try:
        model = DeepFM(deep_features=sparse + (DenseFeature("I0"),), fm_features=sparse, mlp_params={"dims": (16,), "dropout": 0.0}, generator=torch.Generator().manual_seed(seed))
    finally:
        set_fused_default(old)
    return CTRTrainer(model, sparse_embedding="adagrad", seed=seed, device="cpu")


def deepfm_batch(i):
    rng = np.random.default_rng(200 + i)
    x = {f"C{j}": torch.from_numpy(rng.integers(0, 30 + 10 * j, 16)).to(torch.int32) for j in range(3)}
    x["I0"] = torch.from_numpy(rng.normal(size=16).astype(np.float32))
    return x, torch.from_numpy((rng.random(16) < 0.3).astype(np.float32)), torch.ones(16)


BUILDERS = {"hstu": (hstu_trainer, hstu_batch), "deepfm": (deepfm_trainer, deepfm_batch)}


def profiled_step(kind):
    build, batch = BUILDERS[kind]
    trainer = build()
    trainer.train_step(*batch(0))  # optimizer state made outside the capture
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_step(*batch(1))
    return trainer, prof, profiling.spans()


def inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def descendants(record, root):
    out, frontier = [], {root}
    for i, (_, parent, _, _) in enumerate(record):
        if parent in frontier:
            out.append(i)
            frontier.add(i)
    return out


def check_step_spans(prof, record):
    """The step's root and its four stages, in order and each inside its parent, in the events and the record."""
    roots = [i for i, s in enumerate(record) if s[0] == "rechub.train_step"]
    assert len(roots) == 1 and record[roots[0]][1] is None
    root = roots[0]
    children = [i for i, s in enumerate(record) if s[1] == root]
    assert [record[i][0] for i in children] == STAGES
    bounds = lambda i: (record[i][2], record[i][3])  # noqa: E731
    for i in children:
        assert inside(bounds(i), bounds(root))
    assert all(record[a][3] <= record[b][2] for a, b in zip(children, children[1:]))  # one after another

    events = {e.name: e for e in prof.events() if e.name.startswith("rechub.")}
    rng = lambda name: (events[name].time_range.start, events[name].time_range.end)  # noqa: E731
    for name in STAGES:
        assert inside(rng(name), rng("rechub.train_step")) and events[name].cpu_parent.name == "rechub.train_step"
    assert all(rng(a)[1] <= rng(b)[0] for a, b in zip(STAGES, STAGES[1:]))
    return root, children


def test_without_a_profiler_annotate_is_one_shared_no_op(monkeypatch):
    """No ``record_function`` opens and no clock is read: both would raise here."""

    def refuse(*a, **k):
        raise AssertionError("annotate did work with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling.time, "perf_counter_ns", refuse)
    assert not torch.autograd._profiler_enabled()
    first, second = profiling.annotate("rechub.a"), profiling.annotate("rechub.b")
    assert first is second
    with first:
        with second:
            pass
    assert profiling.spans() == [] and profiling.dropped_spans() == 0


def test_a_seq_trainer_step_nests_its_stages_and_the_hstu_spans():
    _, prof, record = profiled_step("hstu")
    root, children = check_step_spans(prof, record)
    forward = children[0]
    under_forward = {record[i][0] for i in descendants(record, forward)}
    assert {"rechub.hstu.forward", "rechub.sparse.gather"} <= under_forward
    hstu = [i for i, s in enumerate(record) if s[0] == "rechub.hstu.forward"]
    assert len(hstu) == 1 and record[hstu[0]][1] == forward
    gathers = [i for i, s in enumerate(record) if s[0] == "rechub.sparse.gather"]
    # the input table's gather inside the model, the output table's candidate rows in the loss
    assert len(gathers) >= 2 and any(record[i][1] == hstu[0] for i in gathers) and all(i in descendants(record, forward) for i in gathers)
    for i in gathers + hstu:
        assert inside(record[i][2:], (record[record[i][1]][2], record[record[i][1]][3]))
    by_name = {}
    for e in prof.events():
        by_name.setdefault(e.name, []).append(e)
    fwd = by_name["rechub.train.forward"][0].time_range
    for e in by_name["rechub.hstu.forward"] + by_name["rechub.sparse.gather"]:
        assert fwd.start <= e.time_range.start and e.time_range.end <= fwd.end


def test_a_ctr_trainer_step_nests_its_stages_and_the_fused_gather():
    trainer, prof, record = profiled_step("deepfm")
    assert trainer.sparse_tables  # the fused table takes row-wise updates
    root, children = check_step_spans(prof, record)
    gathers = [i for i, s in enumerate(record) if s[0] == "rechub.sparse.gather"]
    assert gathers and all(record[i][1] == children[0] for i in gathers)
    assert not any(s[0] == "rechub.hstu.forward" for s in record)


def test_brute_force_topk_records_the_top_k_apart_from_the_product():
    rng = np.random.default_rng(5)
    users, items = rng.normal(size=(6, 8)).astype(np.float32), rng.normal(size=(40, 8)).astype(np.float32)
    plain_ids, plain_scores = brute_force_topk(users, items, 5, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ids, scores = brute_force_topk(users, items, 5, batch_size=4, device="cpu")
    np.testing.assert_array_equal(ids, plain_ids)
    np.testing.assert_array_equal(scores, plain_scores)
    record = profiling.spans()
    assert [s[0] for s in record] == ["rechub.retrieval.topk"] * 2 and all(s[1] is None for s in record)  # two batches of users
    topk = [e for e in prof.events() if e.name == "rechub.retrieval.topk"]
    assert len(topk) == 2
    assert all(any(c.name == "aten::topk" for c in e.cpu_children) for e in topk)
    assert not any(c.name in ("aten::mm", "aten::matmul") for e in topk for c in e.cpu_children)


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_a_profiler_changes_no_number(kind):
    """Two steps with a profiler running and without give the same losses and parameters, bit for bit."""
    build, batch = BUILDERS[kind]
    plain, traced = build(), build()
    plain_losses = [plain.train_step(*batch(i)) for i in range(2)]
    with profile(activities=[ProfilerActivity.CPU]):
        traced_losses = [traced.train_step(*batch(i)) for i in range(2)]
    assert len(profiling.spans()) > 0
    for a, b in zip(plain_losses, traced_losses):
        assert torch.equal(a, b)
    traced_params = dict(traced.model.named_parameters())
    for name, p in plain.model.named_parameters():
        assert torch.equal(p, traced_params[name]), name
    for name, acc in plain.sparse_accums.items():
        assert torch.equal(acc, traced.sparse_accums[name]), name


def test_reading_the_record_does_not_clear_it_and_clear_spans_does():
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("rechub.outer"):
            with profiling.annotate("rechub.inner"):
                pass
    first = profiling.spans()
    assert [(s[0], s[1]) for s in first] == [("rechub.outer", None), ("rechub.inner", 0)]
    assert all(isinstance(s[2], int) and s[2] <= s[3] for s in first)
    assert profiling.spans() == first
    first.clear()  # a snapshot: the caller's copy
    assert len(profiling.spans()) == 2
    profiling.clear_spans()
    assert profiling.spans() == []


def test_the_record_stops_at_its_bound_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with profiling.annotate(f"rechub.s{i}"):
                with profiling.annotate("rechub.child"):
                    pass
    assert [s[0] for s in profiling.spans()] == ["rechub.s0", "rechub.child", "rechub.s1"]  # the newest dropped
    assert profiling.dropped_spans() == 7
    profiling.clear_spans()
    assert profiling.dropped_spans() == 0


def test_a_span_left_by_an_exception_closes_and_is_no_later_span_parent():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with profiling.annotate("rechub.failed"):
                raise ValueError("a step that raises")
        with profiling.annotate("rechub.next"):
            pass
    record = profiling.spans()
    assert [(s[0], s[1]) for s in record] == [("rechub.failed", None), ("rechub.next", None)]
    assert all(s[3] is not None for s in record)


def test_a_span_open_across_a_clear_is_no_later_span_parent():
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("rechub.old"):
            profiling.clear_spans()
            with profiling.annotate("rechub.new"):
                pass
    assert [(s[0], s[1]) for s in profiling.spans()] == [("rechub.new", None)]
