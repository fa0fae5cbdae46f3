#!/usr/bin/env python3
"""The host cost of the program's spans (``torch_rechub_tpu_torch/utils/profiling.annotate``), on one CUDA card:

    python3 tools/span_cost.py [--calls N]

Times ``N`` empty ``with annotate(...)`` blocks against ``N`` empty loop turns,
five times each, in three cases: no profiler running, a profiler of the card
alone (as ``cardbench``'s lean slice runs it) and one of the host and the card
(its labelled slice).  Prints one JSON line: each case's median µs a span over
the bare loop, whether the profiler reads as on, and how many spans the record
holds; then the card's name and power limit.

Exits with a message when no CUDA device is present.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_rechub_tpu_torch.utils.profiling import annotate, clear_spans, spans  # noqa: E402


def per_call_us(calls: int, span: bool) -> float:
    t0 = time.perf_counter()
    if span:
        for _ in range(calls):
            with annotate("rechub.cost"):
                pass
    else:
        for _ in range(calls):
            pass
    return (time.perf_counter() - t0) * 1e6 / calls


def case(calls: int) -> dict:
    clear_spans()
    with_span = statistics.median(per_call_us(calls, True) for _ in range(5))
    bare = statistics.median(per_call_us(calls, False) for _ in range(5))
    return {"us_per_span": with_span - bare, "profiler_on": torch.autograd._profiler_enabled(), "recorded": len(spans())}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=10000)
    calls = ap.parse_args().calls
    if not torch.cuda.is_available():
        raise SystemExit("span_cost: no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    out = {"off": case(calls)}
    for label, activities in (("card", [ProfilerActivity.CUDA]), ("host_and_card", [ProfilerActivity.CPU, ProfilerActivity.CUDA])):
        with profile(activities=activities):
            out[label] = case(calls)
    clear_spans()
    limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"], capture_output=True, text=True).stdout.strip()
    print(json.dumps({"calls": calls, **out, "device": torch.cuda.get_device_name(0), "power_limit": limit}))


if __name__ == "__main__":
    main()
