#!/usr/bin/env python3
"""Device times of the rab backward kernels K2 and K2a, fp32 and bf16, on one CUDA card, to compare two
checkouts of the port in one call:

    python3 tools/rab_backward_times.py [--repo DIR]

``--repo``: the checkout whose ``torch_rechub_tpu_torch`` is timed (default: this one), e.g. an earlier commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists; its kernels are built from its own
sources into its own ``build/kernels``.  The shapes: the serving one (B8 H8 L256, dqk = dv = 32, sorted stamps,
suffix padding: the shape of PERF.md's kernel table), the production recipe's (B8 H4 L256, dqk = dv = 64), and the
serving one with shuffled stamps over 2,000 and over 12,000 time buckets, where the dts sums leave the copies per
lane column for a table per warp, and for one table which the warps add to in turns (``rab.dts_tables``).
Each time is the median device time of 30 calls of the wrapper (``rab_backward_fused``, ``rab_backward_dq``, so
the table sums' second kernel and the scratch buffer are included where a checkout has them), taken by
``chip_smoke.timed``; the card's name and power limit first, one JSON line last.

Exits with a message when no CUDA device is present.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=ROOT, help="the checkout to time (default: this one)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tools/rab_backward_times.py needs a CUDA device")
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    from torch_rechub_tpu_torch.ops.cuda import _build
    from torch_rechub_tpu_torch.ops.cuda import hstu_rab_attention as rab

    sys.path.insert(1, ROOT)
    import chip_smoke as cs  # its timing and cases; the package stays the one imported above

    assert rab.__file__.startswith(repo + os.sep), rab.__file__  # the checkout asked for, not this one
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    print(f"timing {repo}: built in {_build.build_all():.1f} s")
    cycles_per_ms = cs.spin_cycles_per_ms()
    out = {}
    cases = (("serving B8 H8 L256 d32", dict(seed=0, b=8, l=256, max_seq_len=256)), ("production B8 H4 L256 d64", dict(seed=41, b=8, l=256, max_seq_len=256, h=4, d=64)),
             ("B8 H8 L256 d32 2,000 buckets", dict(seed=42, b=8, l=256, max_seq_len=256, times="shuffled", nb=2_000)),
             ("B8 H8 L256 d32 12,000 buckets", dict(seed=43, b=8, l=256, max_seq_len=256, times="shuffled", nb=12_000)))
    for label, case in cases:
        c32 = cs.rab_case(**case)
        for bf16 in (False, True):
            c = cs.bf16_case(c32) if bf16 else c32
            g = torch.from_numpy(np.random.default_rng(10).normal(size=tuple(c["v"].shape)).astype(np.float32)).cuda().to(c["v"].dtype)
            fn_args = (c["q"], c["k"], c["v"], g, c["pos_w"], c["ts_w"], c["ts"], c["mask"], c["alpha"], c["max_seq_len"], c["cfg"], c["thr"])
            for name, fn in (("hstu_rab_bwd", rab.rab_backward_fused), ("hstu_rab_bwd_dq", rab.rab_backward_dq)):
                name += "_bf16" if bf16 else ""
                ms, wall = cs.timed(lambda: fn(*fn_args), cycles_per_ms)
                out[f"{name} {label}"] = ms
                print(f"  {name} at {label}: device {ms:.4f} ms, host clock {wall:.4f} ms (medians of {cs.REPS})")
    print(json.dumps({"repo": repo, "ms": out}))


if __name__ == "__main__":
    main()
