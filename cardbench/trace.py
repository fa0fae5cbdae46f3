"""The traced slices of a ``--trace 1`` run and their reduction to what the layer metrics read.

``capture`` profiles ``n`` steps or requests twice with ``torch.profiler``,
keeping nothing on disk:

- a lean slice with the device's activity alone, whose host cost is small:
  the device's kernels, copies and fills as ``(name, start, end)`` seconds;
  ``busy_s``, the union of their intervals, so overlapping work counts
  once; ``window_s``, the slice's host-clock seconds, ended by a
  synchronise;
- a labelled slice with the host's operators too, inside a
  ``cardbench.window`` span: the benchmark's own spans as they ran on the
  device, and the ten longest idle gaps of the device, each named by the
  innermost host operator that ran at the gap's middle.  Recording every
  host operator slows the host, so no busy share or rate is read from it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Tuple

import torch

Interval = Tuple[str, float, float]
NAME_CHARS = 160
PROFILER_OWN = ("Activity Buffer Request",)  # the profiler's own host work, not the program's


@dataclasses.dataclass
class Slice:
    device: List[Interval]  # kernels, copies, fills
    device_spans: List[Interval]  # record_function spans as they ran on the device
    host_spans: List[Interval]  # the benchmark's record_function spans on the host
    host_ops: List[Interval]
    n: int  # steps or requests in the slice
    wall_s: float


@dataclasses.dataclass
class Trace:
    lean: Slice
    labelled: Slice

    @property
    def n(self) -> int:
        return self.lean.n

    @property
    def device(self) -> List[Interval]:
        return self.lean.device

    @property
    def window_s(self) -> float:
        return self.lean.wall_s

    @property
    def busy_s(self) -> float:
        return union_length([(s, e) for _, s, e in self.lean.device])

    def kernels(self) -> List[Interval]:
        return [k for k in self.lean.device if not k[0].startswith(("Memcpy", "Memset"))]

    def device_ops(self, top: int = 10) -> List[list]:
        total: Dict[str, float] = {}
        for name, s, e in self.lean.device:
            total[name] = total.get(name, 0.0) + (e - s)
        return [[n[:NAME_CHARS], t] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        lab = self.labelled
        window = next(((s, e) for name, s, e in lab.host_spans if name == "cardbench.window"), None)
        if window is None:
            return []
        lo, hi = window
        gaps, cursor = [], lo
        for s, e in merge([(max(s, lo), min(e, hi)) for _, s, e in lab.device]) + [(hi, hi)]:
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, e)
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[host_at(lab.host_ops, (s + e) / 2)[:NAME_CHARS], e - s] for s, e in gaps[:top]]


def host_at(host_ops: List[Interval], t: float) -> str:
    inner = [(e - s, n) for n, s, e in host_ops if s <= t <= e and n not in PROFILER_OWN]
    return min(inner)[1] if inner else "host idle between operators"


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(i for i in intervals if i[1] > i[0]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_length(intervals: List[Tuple[float, float]], lo: float = float("-inf"), hi: float = float("inf")) -> float:
    return sum(e - s for s, e in merge([(max(s, lo), min(e, hi)) for s, e in intervals]))


def profiled(step: Callable[[int], object], first: int, n: int, host: bool) -> Slice:
    """Profile ``step(first) .. step(first + n - 1)``, ended by a synchronise."""
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = torch.cuda.is_available()
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    activities = ([ProfilerActivity.CUDA] if on_card else []) + ([ProfilerActivity.CPU] if host or not on_card else [])
    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with record_function("cardbench.window"):
            for i in range(first, first + n):
                step(i)
            sync()
        wall = time.perf_counter() - t0
    return reduce(prof.events(), n, wall)


def capture(step: Callable[[int], object], n: int) -> Trace:
    """The lean slice of steps ``0 .. n - 1``, then the labelled one of ``n .. 2n - 1``."""
    return Trace(profiled(step, 0, n, host=False), profiled(step, n, n, host=True))


def reduce(events, n: int, wall_s: float) -> Slice:
    device, device_spans, host_spans, host_ops = [], [], [], []
    for e in events:
        iv = (e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            (device_spans if e.name.startswith("cardbench.") or getattr(e, "is_user_annotation", False) else device).append(iv)
        elif e.name.startswith("cardbench."):
            host_spans.append(iv)
        else:
            host_ops.append(iv)
    return Slice(device, device_spans, host_spans, host_ops, n, wall_s)
