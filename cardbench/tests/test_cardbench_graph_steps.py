"""The reader of ``graph_steps.train`` on hand-made span records: the share of the lean slice's steps that replayed
CUDA graphs, and ``None`` for a program without a graph path."""

from types import SimpleNamespace

import pytest

from cardbench import harness
from cardbench.trace import Trace, reduce
from torch_rechub_tpu_torch.utils import profiling

MS = 1_000_000  # ns
GRAPHED = [("rechub.train.graph", 6.0), ("rechub.train.sparse_update", 0.5)]
EAGER = [("rechub.train.forward", 3.0), ("rechub.train.backward", 2.0), ("rechub.train.optimizer", 1.5), ("rechub.train.sparse_update", 0.5)]


def ctx(n):
    return SimpleNamespace(trace=Trace(reduce([], n, 1.0), reduce([], n, 1.0)))


def record_of(steps):
    """Steps' spans in one record: each a root, then its stages as its children."""
    out = []
    for stages in steps:
        root = len(out)
        out.append(("rechub.train_step", None, 0, 10 * MS))
        out += [(name, root, 0, int(ms * MS)) for name, ms in stages]
    return out


@pytest.fixture
def record(monkeypatch):
    held = []
    monkeypatch.setattr(profiling, "spans", lambda: list(held))
    return held


@pytest.mark.parametrize("lean,expected", [([GRAPHED] * 4, 100.0), ([EAGER] + [GRAPHED] * 3, 75.0), ([EAGER] * 4, 0.0)])
def test_the_share_of_the_lean_slices_steps_that_replayed_graphs(record, lean, expected):
    record += record_of(lean + [EAGER] * 4)  # the labelled slice's steps come after the lean slice's
    assert harness.layer_metric("graph_steps.train")(ctx(4)) == pytest.approx(expected)


def test_a_graph_span_outside_the_lean_slice_is_not_counted(record):
    record += record_of([EAGER] * 2 + [GRAPHED] * 2) + [("rechub.train.graph", None, 0, MS)]
    assert harness.layer_metric("graph_steps.train")(ctx(2)) == 0.0


def test_no_steps_of_the_lean_slice_read_nothing(record):
    record += record_of([GRAPHED] * 2)
    assert harness.layer_metric("graph_steps.train")(ctx(2)) is None


def test_a_program_without_a_graph_path_reads_nothing(record, monkeypatch):
    record += record_of([GRAPHED] * 4)
    monkeypatch.delattr(profiling, "counters")
    assert harness.layer_metric("graph_steps.train")(ctx(2)) is None
