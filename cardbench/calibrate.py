"""The readings that the limits of ``cardbench/limits/<cell>.json`` are set from, at the cell's own size on the card.

For each seed of ``--seeds`` one process runs the cell's set-up and a
window of ``--seconds`` (0 for training: its readings need none) and prints
the numbers the comparison reads.  For the first ``--controls`` seeds it
also reads the control, the reference put in the program's place and run
in TF32 (the precision below the configurations' float32), and each fault
of ``cardbench/faults.py`` planted in the program:

    python3 cardbench/calibrate.py --workload hstu-books.train --seeds 11,12,13 --controls 3 --seconds 0

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

from cardbench import control, faults, harness  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--faults", default=None, help="the faults to plant, by name (default: every fault of the cell's driver)")
    args = ap.parse_args()
    harness.set_cache_dirs()
    c = harness.resolve(args.workload)
    device = harness.check_cards(c.workload["chips"])
    planted = {"train": faults.TRAIN, "serve": faults.SERVE}[c.traffic["driver"]]
    if args.faults is not None:
        planted = {name: planted[name] for name in args.faults.split(",") if name}
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = c.driver.run(c, seed, args.seconds, False, device, t0)
        line = {"workload": args.workload, "seed": seed, "reading": "program", "checks": out["checks"], "correct": out["correct"], "end_to_end": out["end_to_end"]}
        print(json.dumps(harness.finite(line)), flush=True)
        if n < args.controls:
            print(json.dumps(harness.finite({"workload": args.workload, "seed": seed, "reading": "control_tf32", "checks": control.checks(c, out, seed, device)})), flush=True)
            for name, fault in planted.items():
                bad = c.driver.run(c, seed, args.seconds, False, device, time.perf_counter(), fault=fault)
                print(json.dumps(harness.finite({"workload": args.workload, "seed": seed, "reading": f"fault_{name}", "checks": bad["checks"], "correct": bad["correct"]})), flush=True)
        del out


if __name__ == "__main__":
    main()
