"""The readers of the program's spans (``cardbench/layer_metrics/_spans.py``) on hand-made slices and span records.

Slices are built from events the way ``test_cardbench_trace.py`` builds
them; the program's in-memory record (``utils/profiling.spans()``) is
replaced by a hand-made one.  Times: events in microseconds, the record in
nanoseconds.
"""

from types import SimpleNamespace

import pytest
import torch

from cardbench import harness
from cardbench.trace import Trace, reduce
from torch_rechub_tpu_torch.utils import profiling

TRAIN_HOST = ["step_host_ms.train", "optimizer_host_ms.train", "forward_host_ms.train", "backward_host_ms.train"]
DEVICE = ["sparse_gather_ms.train", "sparse_update_ms.train", "topk_ms.serve"]
ALL = TRAIN_HOST + ["forward_host_ms.serve", "host_syncs_per_step.train"] + DEVICE
MS = 1_000_000  # ns


def ev(name, start_us, end_us, device=False, annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start_us, end=end_us), is_user_annotation=annotation,
                           device_type=torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU)


def ctx(lean_events=(), labelled_events=(), n=2):
    return SimpleNamespace(trace=Trace(reduce(list(lean_events), n, 1.0), reduce(list(labelled_events), n, 1.0)))


def step_record(step_ms, stages_ms):
    """One step's spans as the trainer opens them: the root, then its stages one after another from its start."""
    return [("rechub.train_step", None, 0, step_ms * MS)] + [(name, 0, 0, ms * MS) for name, ms in stages_ms]


def record_of(steps):
    """Steps' spans in one record, each step's parent indices shifted to its place."""
    out = []
    for spans in steps:
        base = len(out)
        out += [(name, None if parent is None else parent + base, s, e) for name, parent, s, e in spans]
    return out


@pytest.fixture
def record(monkeypatch):
    """Hand the readers ``record`` as the program's span record."""
    held = []
    monkeypatch.setattr(profiling, "spans", lambda: list(held))
    return held


STAGES = [("rechub.train.forward", 3.0), ("rechub.train.backward", 2.0), ("rechub.train.optimizer", 1.5), ("rechub.train.sparse_update", 0.5)]
LEAN = [step_record(10.0, STAGES), step_record(12.0, [(n, 2 * ms) for n, ms in STAGES])]
LABELLED = [step_record(100.0, [(n, 50.0) for n, _ in STAGES])] * 2  # the host operators' cost: never read


@pytest.mark.parametrize("metric,expected", [
    ("step_host_ms.train", 11.0), ("forward_host_ms.train", 4.5), ("backward_host_ms.train", 3.0), ("optimizer_host_ms.train", 2.25),
])
def test_a_host_reader_takes_the_lean_slices_first_n_roots_and_their_stages(record, metric, expected):
    record += record_of(LEAN + LABELLED)
    assert harness.layer_metric(metric)(ctx(n=2)) == pytest.approx(expected)


def test_the_serving_forward_reads_root_spans_only(record):
    nested = record_of([step_record(10.0, [("rechub.train.forward", 4.0)]) + [("rechub.hstu.forward", 1, 0, 3 * MS)]])
    served = [("rechub.hstu.forward", None, 0, ms * MS) for ms in (6.0, 8.0, 40.0, 40.0)]
    record += nested + record_of([[s] for s in served])
    assert harness.layer_metric("forward_host_ms.serve")(ctx(n=2)) == pytest.approx(7.0)


def test_a_host_reader_without_the_lean_slices_own_roots_reads_nothing(record):
    record += record_of(LABELLED)  # a lean slice that recorded nothing: the first n would be the labelled slice's
    assert all(harness.layer_metric(m)(ctx(n=2)) is None for m in TRAIN_HOST)


def test_a_stage_without_spans_reads_nothing(record):
    record += record_of([step_record(10.0, [])] * 4)
    assert harness.layer_metric("step_host_ms.train")(ctx(n=2)) == pytest.approx(10.0)
    assert harness.layer_metric("optimizer_host_ms.train")(ctx(n=2)) is None


@pytest.mark.parametrize("metric,span", [
    ("sparse_gather_ms.train", "rechub.sparse.gather"), ("sparse_update_ms.train", "rechub.train.sparse_update"), ("topk_ms.serve", "rechub.retrieval.topk"),
])
def test_a_device_reader_reads_the_union_of_work_inside_its_ranges(metric, span):
    labelled = [
        ev("gemm", 0, 10, device=True), ev("gather_a", 10, 20, device=True), ev("gather_b", 15, 25, device=True),  # overlap counts once
        ev("scatter", 40, 55, device=True), ev("Memcpy DtoH", 60, 70, device=True),
        ev(span, 10, 25, device=True, annotation=True), ev(span, 50, 55, device=True, annotation=True),  # 15 + 5 us over 2 steps: 10 us
        ev(span, 52, 54, device=True, annotation=True),  # inside the last: counted once
        ev(span, 10, 25), ev("rechub.other", 40, 60, device=True, annotation=True),
    ]
    assert harness.layer_metric(metric)(ctx(labelled_events=labelled, n=2)) == pytest.approx(0.010)


def test_host_syncs_count_waiting_calls_inside_the_steps_on_any_thread():
    labelled = [
        ev("rechub.train_step", 0, 100), ev("rechub.train_step", 200, 300),
        ev("cudaStreamSynchronize", 50, 60), ev("cudaMemcpy", 250, 251),  # inside: 2
        ev("cudaEventSynchronize", 99, 130),  # starts inside, ends after: counted
        ev("cudaMemcpyAsync", 20, 21), ev("cudaLaunchKernel", 30, 31),  # do not wait
        ev("cudaDeviceSynchronize", 305, 400),  # the slice's closing synchronise
        ev("cudaStreamSynchronize", 150, 160),  # between the steps
    ]
    assert harness.layer_metric("host_syncs_per_step.train")(ctx(labelled_events=labelled, n=2)) == pytest.approx(1.5)
    quiet = [ev("rechub.train_step", 0, 100), ev("rechub.train_step", 200, 300), ev("cudaLaunchKernel", 30, 31)]
    assert harness.layer_metric("host_syncs_per_step.train")(ctx(labelled_events=quiet, n=2)) == 0.0


@pytest.mark.parametrize("metric", ALL)
def test_a_reader_returns_none_without_its_span(record, metric):
    plain = [ev("gemm", 0, 10, device=True), ev("aten::mm", 0, 5), ev("cudaStreamSynchronize", 6, 7), ev("cardbench.window", 0, 20)]
    assert harness.layer_metric(metric)(ctx(plain, plain, n=2)) is None


@pytest.mark.parametrize("metric", TRAIN_HOST + ["forward_host_ms.serve"])
def test_a_host_reader_returns_none_for_a_program_without_a_span_record(monkeypatch, metric):
    monkeypatch.delattr(profiling, "spans")
    assert harness.layer_metric(metric)(ctx(n=2)) is None


def test_a_program_user_annotation_is_a_device_span_never_a_kernel():
    events = [ev("gemm", 0, 10, device=True), ev("rechub.sparse.gather", 20, 30, device=True, annotation=True),
              ev("rechub.sparse.gather", 20, 30), ev("rechub.train_step", 0, 40)]
    t = Trace(reduce(events, 1, 1.0), reduce(events, 1, 1.0))
    assert [k[0] for k in t.kernels()] == ["gemm"] and [d[0] for d in t.device] == ["gemm"]
    assert [s[0] for s in t.labelled.device_spans] == ["rechub.sparse.gather"] and t.busy_s == pytest.approx(10e-6)
    assert {n for n, _, _ in t.labelled.host_ops} == {"rechub.sparse.gather", "rechub.train_step"}
