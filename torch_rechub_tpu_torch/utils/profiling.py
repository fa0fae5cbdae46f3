"""Tracing / profiling hooks.

Counterpart of ``torch_rechub_tpu/utils/profiling.py``:

- ``trace(log_dir)``: a ``torch.profiler`` capture of everything inside
  (host operations and, with a card, its kernels and copies), written as a
  Chrome trace to ``<log_dir>/trace.json`` (open it in Perfetto or
  ``chrome://tracing``).
- ``annotate(name)``: ``torch.profiler.record_function``, so a phase of the
  host code shows as a named span inside a capture.
- ``StepTimer``: per-step wall-clock durations with the JAX package's summary
  keys.
- ``device_memory_stats()``: ``torch.cuda.memory_stats`` of every visible card.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture the enclosed block with ``torch.profiler`` (the card's activity too, where there is one) and write
    ``<log_dir>/trace.json``; yields the profiler, whose ``key_averages()`` the caller may read."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named span annotation inside an active trace."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Accumulates per-step durations; ``summary()`` gives mean/p50/p99 + rate."""

    def __init__(self, examples_per_step: Optional[int] = None):
        self.durations: List[float] = []
        self.examples_per_step = examples_per_step
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.durations.append(time.perf_counter() - self._t0)
        return False

    def summary(self) -> Dict[str, float]:
        if not self.durations:
            return {}
        d = np.asarray(self.durations)
        out = {
            "steps": len(d),
            "mean_s": float(d.mean()),
            "p50_s": float(np.percentile(d, 50)),
            "p99_s": float(np.percentile(d, 99)),
            "total_s": float(d.sum()),
        }
        if self.examples_per_step:
            out["examples_per_s"] = self.examples_per_step / out["mean_s"]
        return out

    def reset(self):
        self.durations.clear()


def device_memory_stats() -> Dict[str, Dict]:
    """``torch.cuda.memory_stats`` of every visible card, keyed ``cuda:<i>``; empty without one."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}
