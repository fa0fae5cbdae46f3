"""The trace reduction: busy time is the union of the device's intervals, idle gaps are named by the host."""

from types import SimpleNamespace

import pytest
import torch

from cardbench.trace import Trace, reduce, union_length


def ev(name, start_us, end_us, device=False, annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start_us, end=end_us), is_user_annotation=annotation,
                           device_type=torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU)


def test_union_counts_overlap_once():
    assert union_length([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]) == 4.0
    assert union_length([(0.0, 2.0), (1.0, 3.0)], 1.5, 2.5) == 1.0


def test_lean_slice_gives_busy_window_and_kernels():
    lean = reduce([ev("gemm", 15, 40, device=True), ev("scatter", 30, 45, device=True), ev("Memcpy DtoH", 80, 85, device=True)], n=2, wall_s=1e-4)
    t = Trace(lean, lean)
    assert t.window_s == pytest.approx(1e-4) and t.busy_s == pytest.approx(35e-6)
    assert [k[0] for k in t.kernels()] == ["gemm", "scatter"] and t.device_ops()[0] == ["gemm", pytest.approx(25e-6)]


def test_labelled_slice_names_the_idle_gaps():
    labelled = reduce([
        ev("cardbench.window", 0, 100), ev("aten::mm", 10, 20), ev("optimizer step", 50, 90),
        ev("gemm", 15, 40, device=True), ev("scatter", 30, 45, device=True), ev("Memcpy DtoH", 80, 85, device=True),
        ev("cardbench.retrieval", 12, 44, device=True), ev("Optimizer.step#Adam.step", 50, 90, device=True, annotation=True),
    ], n=2, wall_s=1e-4)
    assert [n for n, _, _ in labelled.device_spans] == ["cardbench.retrieval", "Optimizer.step#Adam.step"]
    gaps = Trace(labelled, labelled).idle_gaps()
    assert gaps[0][0] == "optimizer step" and gaps[0][1] == pytest.approx(35e-6)
    assert gaps[1][0] == "host idle between operators" and gaps[1][1] == pytest.approx(15e-6)


def test_no_window_span_no_gaps():
    s = reduce([ev("aten::mm", 0, 1)], n=1, wall_s=1.0)
    assert Trace(s, s).idle_gaps() == []
