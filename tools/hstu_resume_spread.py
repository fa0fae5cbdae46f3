#!/usr/bin/env python3
"""How far apart runs of the serving HSTU land, behind the HSTU resume check of ``chip_smoke.py``'s lifecycle
phase, on one CUDA card:

    python3 tools/hstu_resume_spread.py [--straight 4] [--resumed 3]

For the fused backward (K2) and the split one (K2a + K2b), by default and under
``torch.use_deterministic_algorithms``: straight runs of 8 steps, resumed runs (4 steps, a checkpoint, a fresh
trainer, ``maybe_resume``, 4 more) and a control, a resumed run whose Adam moments are zeroed after the restore (a
resume that loses the optimizer's state).  Each pair of runs is printed with two statistics: ``chip_smoke.rel_diff``
(the largest over the tensors of max |a - b| over max |b|) and ``chip_smoke.rel_l2`` (||a - b|| over ||b||, over
all parameters at once).

Exits with a message when no CUDA device is present.
"""

import argparse
import os
import shutil
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as c  # noqa: E402

SCRATCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build", "hstu_resume_spread")


def build():
    return c.SeqTrainer(c.HSTUModel(**c.SERVE, generator=torch.Generator().manual_seed(11), device=c.CARD), vocab_chunk_size=8192)


def straight(ld):
    tr = build()
    tr.train_one_epoch(ld["all"], log_interval=0)
    return c.params_of(tr)


def resumed(ld, directory, zero_moments=False):
    first = build()
    first.enable_step_checkpointing(directory, every_n_steps=c.LIFE["half"], max_to_keep=1)
    first.train_one_epoch(ld["first"], log_interval=0)
    first.maybe_step_checkpoint()
    del first
    tr = build()
    tr.enable_step_checkpointing(directory, every_n_steps=c.LIFE["half"], max_to_keep=1)
    if tr.maybe_resume() != c.LIFE["half"]:
        raise AssertionError(f"no checkpoint of step {c.LIFE['half']}")
    if zero_moments:
        for opt in getattr(tr.optimizer, "optimizers", [tr.optimizer]):
            for st in opt.state.values():
                for k in ("exp_avg", "exp_avg_sq"):
                    st[k].zero_()
    tr.train_one_epoch(ld["second"], log_interval=0)
    shutil.rmtree(directory)
    return c.params_of(tr)


def report(tag, runs):
    names = list(runs)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            d, at = c.rel_diff(runs[a], runs[b])
            print(f"  {tag}: {a} vs {b}: rel_diff {d:.3e} ({at}), rel_l2 {c.rel_l2(runs[a], runs[b]):.3e}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--straight", type=int, default=4)
    ap.add_argument("--resumed", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tools/hstu_resume_spread.py needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    data = c.serving_data(c.BATCH * c.LIFE["steps"], c.SERVE["max_seq_len"], c.SERVE["vocab_size"], seed=11, pad=False)
    half = c.BATCH * c.LIFE["half"]
    ld = {"all": c.SeqLoader(*data, batch_size=c.BATCH), "first": c.SeqLoader(*(a[:half] for a in data), batch_size=c.BATCH),
          "second": c.SeqLoader(*(a[half:] for a in data), batch_size=c.BATCH)}
    print(f"run-to-run differences after {c.LIFE['steps']} steps (s: straight, r: {c.LIFE['half']} + resume + {c.LIFE['half']}, "
          "z: the same with Adam's moments zeroed after the restore):")
    for deterministic in (False, True):
        if deterministic:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(deterministic)
        for fused, kernels in ((True, "K2"), (False, "K2a + K2b")):
            c.rab._FUSED_BWD[0] = fused
            try:
                runs = {f"s{i}": straight(ld) for i in range(args.straight)}
                runs.update({f"r{i}": resumed(ld, os.path.join(SCRATCH, f"r{i}")) for i in range(args.resumed)})
                runs["z"] = resumed(ld, os.path.join(SCRATCH, "z"), zero_moments=True)
            finally:
                c.rab._FUSED_BWD[0] = True
            report(f"{kernels}{', deterministic' if deterministic else ''}", runs)
            del runs
            torch.cuda.empty_cache()
    shutil.rmtree(SCRATCH, ignore_errors=True)


if __name__ == "__main__":
    main()
