"""The control: the reference put in the program's place and run in TF32, the precision below the
configurations' float32, judged as the program is.  It has to come out as not correct."""

from __future__ import annotations

import torch

from . import judge, weights
from .drivers import train


def checks(c, out: dict, seed: int, device) -> dict:
    """The control's numbers for a run ``out`` of the cell ``c`` (a driver's result on the same seed)."""
    kind, cfg, specs = c.kind, c.cfg, c.kind.specs(c.cfg)
    if c.traffic["driver"] == "train":
        batches = [{k: t.to(device) for k, t in b.items()} for b in out["checked"]]
        ctrl = train.reference_readings(kind, cfg, specs, batches, seed, device, tf32=True)
        return judge.train_gaps(ctrl, out["reference"])
    w = weights.make(specs, seed, device)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        answers = [kind.reference_answer(cfg, w, b, c.traffic["top_k"]) for b, _, _ in out["checked"]]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    return judge.serve_gaps([{"ids": i, "scores": s} for i, s in answers], out["reference"])
