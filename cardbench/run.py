"""The benchmark's one command: ``python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``.

Runs one cell of ``BENCHMARK.json`` once on the card (``cardbench/harness.py``)
and prints its result as the last line of standard output.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here, before any import

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
# compiled bytecode of every module the run imports, kept inside the checkout: the second run imports it
sys.pycache_prefix = str(Path(__file__).resolve().parents[1] / "build" / "cache" / "pycache")
sys.dont_write_bytecode = False

from cardbench import harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


if __name__ == "__main__":
    harness.report(harness.run(parse(), T0))
