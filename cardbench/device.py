"""The card's side of a run: kernel builds, synchronisation, peak memory, freeing the program."""

from __future__ import annotations

import gc
import sys
import time

import torch


def build_kernels(names, device) -> None:
    """Build the cell's own kernels of the program (``ops/cuda/_build.py``), into the checkout's build directory."""
    if device.type != "cuda" or not names:
        return
    from torch_rechub_tpu_torch.ops.cuda import _build

    _build.build_all(names)


class Phases:
    """Seconds since the process started at each stage of set-up, written to standard error (before the checks)."""

    def __init__(self, t0: float, device):
        self.t0, self.device, self.marks = t0, device, []

    def mark(self, name: str) -> None:
        sync(self.device)
        self.marks.append((name, time.perf_counter() - self.t0))

    def write(self) -> None:
        print("cardbench set-up: " + ", ".join(f"{n} {t:.3f} s" for n, t in self.marks), file=sys.stderr)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def release(device) -> None:
    """Return the freed program's memory before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
