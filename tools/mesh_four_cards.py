#!/usr/bin/env python3
"""The mesh over NCCL with one card a rank, on a host of four cards:

    python3 tools/mesh_four_cards.py

Four ranks, one on each card, over NCCL (``parallel.distributed.spawn``, the backend chosen by
``default_backend``), run ``chip_smoke.mesh_ranks`` on a ``(2, 2)`` mesh: the serving HSTU at a vocab of 65,536
(B8, chunked 8192, four steps) against each rank's mesh=None run, with each step's CUDA-event time and the gradient
all-reduce's host clock; DeepFM at the Criteo-full geometry with sparse Adagrad, its fused table in two row shards
and the batch in two, against mesh=None under deterministic algorithms; exact top-10 over 1M items split four
ways against the unsharded call.  Prints the cards' name and power limit and the launches of K1 and K2 summed over
the ranks.  Exits with a message when fewer than four CUDA devices are present.
"""

import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as c  # noqa: E402
from torch_rechub_tpu_torch.ops.cuda import _build  # noqa: E402
from torch_rechub_tpu_torch.parallel import distributed as pdist  # noqa: E402

RANKS, SHAPE = 4, (2, 2)


def main():
    if torch.cuda.device_count() < RANKS:
        raise SystemExit(f"tools/mesh_four_cards.py needs {RANKS} CUDA devices; found {torch.cuda.device_count()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, backend {pdist.default_backend(RANKS)} for {RANKS} ranks")
    print(f"build: {_build.build_all():.1f} s")  # here, once: the ranks load the libraries
    out = os.path.join(c.MESH_DIR, "four.npz")
    shutil.rmtree(c.MESH_DIR, ignore_errors=True)
    os.makedirs(c.MESH_DIR)
    t0 = time.perf_counter()
    try:
        pdist.spawn(c.mesh_ranks, RANKS, args=(out, (SHAPE,)), timeout_s=600)
        launches = {k: sum(int(np.load(out.replace(".npz", f"_rank{r}.npz"))[k]) for r in range(RANKS)) for k in c.COUNTERS}
    finally:
        shutil.rmtree(c.MESH_DIR, ignore_errors=True)
    print(f"launches summed over the ranks: " + ", ".join(f"{k} {v}" for k, v in launches.items() if v) + f"; {time.perf_counter() - t0:.1f} s, the ranks' start included")


if __name__ == "__main__":
    main()
