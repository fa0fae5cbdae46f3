"""Readings for the limits of the cells whose drivers or faults ``calibrate.py`` does not know: ``train`` cells
with faults of their own, and ``train_dp`` cells.

For each seed of ``--seeds`` one run of the cell's set-up and first steps
(``--seconds`` of window, 0 by default) prints the numbers the comparison
reads; for the first ``--controls`` seeds also the control (the reference
in TF32, the precision below the configurations' float32, judged as the
program is) and, for the first ``--fault-seeds`` seeds, each planted fault:
``faults.TRAIN`` and ``faults_moe.MOE`` for a ``train`` cell, ``faults.TRAIN``
and ``faults_dp.DP`` for a ``train_dp`` cell (``--faults`` picks some by
name).  A run of ``hllm_moe`` also reports its routing ties.

    python3 cardbench/readings.py --workload hllm-dsv2lite-books.train --seeds 11,12,13 --controls 3 --fault-seeds 2

One JSON line a reading; nothing here runs in the benchmark's own runs.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.pycache_prefix = str(Path(__file__).resolve().parents[1] / "build" / "cache" / "pycache")
sys.dont_write_bytecode = False

from cardbench import faults, faults_dp, faults_moe, harness, judge  # noqa: E402
from cardbench.drivers import train  # noqa: E402

PLANTED = {"train": {**faults.TRAIN, **faults_moe.MOE}, "train_dp": {**faults.TRAIN, **faults_dp.DP}}


def control(c, out, seed, device) -> dict:
    batches = [{k: t.to(device) for k, t in b.items()} for b in out["checked"]]
    return judge.train_gaps(train.reference_readings(c.kind, c.cfg, c.kind.specs(c.cfg), batches, seed, device, tf32=True), out["reference"])


def line(c, seed, reading, out=None, checks=None):
    d = {"workload": c.workload["name"], "seed": seed, "reading": reading, "checks": checks if checks is not None else out["checks"]}
    if out is not None:
        d.update(correct=out["correct"], end_to_end=out["end_to_end"], memory_peak_bytes=out["memory_peak_bytes"])
    ties = getattr(c.kind, "last_ties", None)
    if ties:
        d["routing_ties"] = dict(ties)
    print(json.dumps(harness.finite(d)), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--faults", default=None, help="the faults to plant, by name (default: every fault of the cell)")
    args = ap.parse_args()
    harness.set_cache_dirs()
    harness.pin_cpus()
    c = harness.resolve(args.workload)
    device = harness.check_cards(c.workload["chips"])
    planted = PLANTED[c.traffic["driver"]]
    if args.faults is not None:
        planted = {name: planted[name] for name in args.faults.split(",") if name}
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        out = c.driver.run(c, seed, args.seconds, False, device, time.perf_counter())
        line(c, seed, "program", out)
        if n < args.controls:
            line(c, seed, "control_tf32", checks=control(c, out, seed, device))
        del out
        if n < args.fault_seeds:
            for name, fault in planted.items():
                line(c, seed, f"fault_{name}", c.driver.run(c, seed, args.seconds, False, device, time.perf_counter(), fault=fault))


if __name__ == "__main__":
    main()
