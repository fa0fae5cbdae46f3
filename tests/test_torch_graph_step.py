"""The trainer's CUDA graph path (``torch_rechub_tpu_torch/trainers/graph_step.py``) where no card is needed.

On the CPU the path never engages: the step is the eager one, the
counters of the graph path stay empty and Adam is not made capturable.
The signature that keys a step's graphs, the rebuilding of a batch around
the graphs' inputs, the kernel launch counters a replay advances and the
optimizer option a loaded state carries are checked here too.  The graphs
themselves run in ``tests/test_torch_cuda_graph_step.py`` on the card.
"""

import collections

import numpy as np
import pytest
import torch

from torch_rechub_tpu_torch.basic.features import DenseFeature, SparseFeature
from torch_rechub_tpu_torch.models.generative.hstu import HSTUModel
from torch_rechub_tpu_torch.models.ranking import DeepFM
from torch_rechub_tpu_torch.ops import cuda as kernels
from torch_rechub_tpu_torch.ops.cuda import hstu_rab_attention as rab
from torch_rechub_tpu_torch.ops.embedding import set_fused_default
from torch_rechub_tpu_torch.trainers import CTRTrainer, SeqTrainer
from torch_rechub_tpu_torch.trainers.base import set_capturable
from torch_rechub_tpu_torch.trainers.graph_step import _rebuild, signature
from torch_rechub_tpu_torch.utils import profiling

VOCAB, L, B = 50, 8, 4


@pytest.fixture(autouse=True)
def empty_record():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def hstu_trainer(seed=0):
    model = HSTUModel(vocab_size=VOCAB, d_model=16, n_heads=2, n_layers=1, dqk=8, dv=8, max_seq_len=L, dropout=0.1, num_time_buckets=8,
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
        model = DeepFM(deep_features=sparse + (DenseFeature("I0"),), fm_features=sparse, mlp_params={"dims": (16,), "dropout": 0.1}, generator=torch.Generator().manual_seed(seed))
    finally:
        set_fused_default(old)
    return CTRTrainer(model, sparse_embedding="adagrad", seed=seed, device="cpu")


def deepfm_batch(i):
    rng = np.random.default_rng(200 + i)
    x = {f"C{j}": torch.from_numpy(rng.integers(0, 30 + 10 * j, 16)).to(torch.int32) for j in range(3)}
    x["I0"] = torch.from_numpy(rng.normal(size=16).astype(np.float32))
    return x, torch.from_numpy((rng.random(16) < 0.3).astype(np.float32)), torch.ones(16)


BUILDERS = {"hstu": (hstu_trainer, hstu_batch), "deepfm": (deepfm_trainer, deepfm_batch)}


def adam_groups(trainer):
    opts = getattr(trainer.optimizer, "optimizers", [trainer.optimizer])
    return [g for opt in opts if isinstance(opt, torch.optim.Adam) for g in opt.param_groups]


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_on_the_cpu_the_graph_path_never_engages(kind):
    build, batch = BUILDERS[kind]
    trainer = build()
    for i in range(4):
        trainer.train_step(*batch(0 if i < 3 else 1))
    assert trainer._graphs is None and trainer.step == 4
    assert not any(name.startswith("rechub.train.graph") for name in profiling.counters())
    assert profiling.counters().get("rechub.train.graph.capture", 0) == 0
    assert adam_groups(trainer) and not any(g["capturable"] for g in adam_groups(trainer))


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_successive_steps_return_distinct_tensors_with_their_own_values(kind):
    """The same batch four times, as a graph would replay it: each loss a tensor of its own that keeps its value."""
    build, batch = BUILDERS[kind]
    trainer = build()
    losses, seen = [], []
    for _ in range(4):
        losses.append(trainer.train_step(*batch(0)))
        seen.append(float(losses[-1]))
    assert len({id(x) for x in losses}) == 4 and len({x.data_ptr() for x in losses}) == 4
    assert [float(x) for x in losses] == seen  # later steps left the earlier losses as they were
    assert len(set(seen)) == 4  # the weights moved between the steps
    assert all(x.ndim == 0 and not x.requires_grad for x in losses)


def signature_key(batch, trainer):
    return signature(batch, trainer)[0]


def changed(case, trainer):
    """``(batch, batch changed in one respect)`` for ``case``; the trainer may be changed in between."""
    x, y, w = deepfm_batch(0)
    base = (x, y, w)
    if case == "shape":
        return base, ({**x, "I0": x["I0"][:8]}, y, w)
    if case == "dtype":
        return base, ({**x, "C0": x["C0"].to(torch.int64)}, y, w)
    if case == "dict keys":
        return base, ({**{k: v for k, v in x.items() if k != "I0"}, "I1": x["I0"]}, y, w)
    if case == "dict key order":
        return base, (dict(reversed(list(x.items()))), y, w)
    if case == "a leaf's value":
        return (x, None, w), (x, 0.5, w)
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["shape", "dtype", "dict keys", "dict key order", "a leaf's value"])
def test_the_signature_changes_with_the_batch(case):
    trainer = deepfm_trainer()
    a, b = changed(case, trainer)
    assert signature_key(a, trainer) != signature_key(b, trainer)


@pytest.mark.parametrize("change", ["lr", "precision", "frozen parameter", "split backward", "deterministic algorithms"])
def test_the_signature_changes_with_the_trainer_and_the_kernel_switches(change, monkeypatch):
    trainer = deepfm_trainer()
    batch = deepfm_batch(0)
    before = signature_key(batch, trainer)
    if change == "lr":
        trainer.set_lr(trainer.lr * 0.5)
    elif change == "precision":
        trainer.precision = "bf16"
    elif change == "frozen parameter":
        trainer.optimizer.param_groups[0]["params"][0].requires_grad_(False)
    elif change == "split backward":
        monkeypatch.setattr(rab, "_FUSED_BWD", [False])
    else:
        monkeypatch.setattr(torch, "are_deterministic_algorithms_enabled", lambda: True)
    assert signature_key(batch, trainer) != before


def test_the_signature_holds_for_other_values_at_the_same_shapes():
    trainer = hstu_trainer()
    batch = hstu_batch(0)
    key, tensors = signature(batch, trainer)
    other, _ = signature(hstu_batch(1), trainer)
    assert key == other and hash(key) == hash(other)
    assert len(tensors) == 3 and all(a is b for a, b in zip(tensors, batch))


@pytest.mark.parametrize("leaf", [object(), collections.OrderedDict(a=1), collections.namedtuple("Pair", "a b")(1, 2)])
def test_a_batch_leaf_no_capture_can_key_raises_a_type_error(leaf):
    with pytest.raises(TypeError):
        signature((torch.zeros(2), leaf), hstu_trainer())


def test_rebuild_puts_the_inputs_into_the_batchs_structure():
    x, y, w = deepfm_batch(0)
    batch = (x, None, [y, (w, 3)])
    _, tensors = signature(batch, deepfm_trainer())
    inputs = [t.clone() for t in tensors]
    rebuilt = _rebuild(batch, iter(inputs))
    assert list(rebuilt[0]) == list(x) and rebuilt[1] is None and isinstance(rebuilt[2], list) and isinstance(rebuilt[2][1], tuple)
    assert rebuilt[2][1][1] == 3
    flat = list(rebuilt[0].values()) + [rebuilt[2][0], rebuilt[2][1][0]]
    assert all(a is b for a, b in zip(flat, inputs)) and len(flat) == len(inputs)


def test_launch_counts_take_a_replays_launches_and_give_them_back(monkeypatch):
    monkeypatch.setattr(rab, "launches", 5)
    monkeypatch.setattr(rab, "launches_bwd", 2)
    monkeypatch.setattr(rab, "launches_wide", {"hstu_rab_fwd": 1})
    before = kernels.launch_counts()
    delta = {(rab.__name__, "launches"): 16, (rab.__name__, "launches_bwd"): 16, (rab.__name__, "launches_wide", "hstu_rab_bwd"): 2}
    kernels.add_launch_counts(delta)
    assert (rab.launches, rab.launches_bwd, rab.launches_wide) == (21, 18, {"hstu_rab_fwd": 1, "hstu_rab_bwd": 2})
    kernels.add_launch_counts({k: -n for k, n in delta.items()})
    after = kernels.launch_counts()
    assert {k: n for k, n in after.items() if n} == {k: n for k, n in before.items() if n}


def test_counters_count_without_a_profiler_and_clear_with_the_spans():
    assert not torch.autograd._profiler_enabled()
    for _ in range(3):
        profiling.count("rechub.train.graph.replay")
    held = profiling.counters()
    assert held == {"rechub.train.graph.replay": 3}
    held["rechub.train.graph.replay"] = 0  # a copy
    assert profiling.counters() == {"rechub.train.graph.replay": 3}
    profiling.clear_spans()
    assert profiling.counters() == {}


def test_a_state_saved_with_capturable_adam_loads_into_a_cpu_trainer():
    """A card trainer saves Adam with ``capturable`` on; a CPU trainer that loads it turns it off again and steps."""
    saver, loader = deepfm_trainer(0), deepfm_trainer(1)
    saver.train_step(*deepfm_batch(0))
    set_capturable(saver.optimizer, True, "cpu")  # what a trainer on the card saves
    state = saver.train_state()
    assert all(g["capturable"] for g in state["optimizer"]["param_groups"])
    loader.load_train_state(state)
    assert not any(g["capturable"] for g in adam_groups(loader))
    loss = loader.train_step(*deepfm_batch(1))
    assert np.isfinite(float(loss)) and loader.step == 2


def test_set_capturable_moves_the_step_counts():
    trainer = deepfm_trainer()
    trainer.train_step(*deepfm_batch(0))
    adam = trainer.optimizer
    assert isinstance(adam, torch.optim.Adam) and adam.state
    set_capturable(trainer.optimizer, True, "cpu")
    assert all(g["capturable"] for g in adam.param_groups)
    assert all(s["step"].dtype == torch.float32 and s["step"].device.type == "cpu" for s in adam.state.values())
    set_capturable(trainer.optimizer, False, "cpu")
    assert not any(g["capturable"] for g in adam.param_groups)
