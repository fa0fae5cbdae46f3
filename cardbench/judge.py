"""The numbers that decide ``correct``, each against a limit of the cell's ``limits/<cell>.json``.

Training (``train_gaps``), from three steps of the program and of the
reference on the same inputs:

- ``loss_gap``: the largest ``|loss - ref| / |ref|`` over the steps, and
  ``loss_gap_first``, the first step's alone (a cell's limits file names
  the one it compares: after an update, the loss inherits the swing of
  the changes below);
- ``grad_gap``: over the leaves, the largest gap between the norms of the
  first step's gradient as each optimizer takes it, over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``change_gap``: the median over the leaves of the gap between the norms
  of each leaf's change after the steps, over the larger of the
  reference's norm of that leaf and of the median leaf, leaving out the
  leaves whose reference gradient is under a thousandth of the median
  leaf's (rounding moves them under Adam).  The worst leaf's gap,
  ``change_gap_worst``, is read beside it and compared with no limit: after
  three Adam steps a single leaf swings with the sign rounding gives an
  element whose gradient is near zero (``PERF.md``).

Serving (``serve_gaps``), from the served top-k of sampled requests and the
reference's exact scores of the same users: ``answer_gap``, the widest of
two gaps over every served item, each over the user's largest reference
score magnitude:

- the gap by which the reference's score of the item served at rank ``r``
  lies below the reference's ``r``-th best score (a wrong, repeated or
  misordered item);
- the gap between the served score and the reference's score of that item.

A request that returns another number of users or of items, or no checked
request at all, reads infinity.
"""

from __future__ import annotations

import math
from statistics import median
from typing import Dict, List

import torch


def _finite(x: float) -> float:
    """``x``, or infinity where it is NaN: a gap that cannot be read fails its limit."""
    return x if x == x else math.inf


def _norm_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves) -> list:
    """Each leaf's gap between the two norms, over the larger of the reference's and the median leaf's (infinity for a missing leaf)."""
    scale = median(ref.values())
    return [_finite(abs(prog[n] - ref[n]) / max(ref[n], scale, 1e-30)) if n in prog else math.inf for n in leaves] or [math.inf]


def train_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: ``{"losses": [...], "first_grad_norms": {leaf: norm}, "change_norms": {leaf: norm}}``."""
    losses = [_finite(abs(p - r) / max(abs(r), 1e-30)) for p, r in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        losses.append(math.inf)
    g_ref = ref["first_grad_norms"]
    floor = 1e-3 * median(g_ref.values())
    moving = [n for n in g_ref if g_ref[n] >= floor]
    change = _norm_gaps(prog["change_norms"], ref["change_norms"], moving)
    return {
        "loss_gap": max(losses),
        "loss_gap_first": losses[0] if losses else math.inf,
        "grad_gap": max(_norm_gaps(prog["first_grad_norms"], g_ref, g_ref)),
        "change_gap": median(change),
        "change_gap_worst": max(change),
    }


def serve_gaps(served: List[dict], reference: List[dict]) -> Dict[str, float]:
    """Each ``served`` entry ``{"ids", "scores"}`` (U, k) as returned; each ``reference`` entry
    ``{"best": (U, k) the reference's sorted best scores, "of_served": (U, k) its scores of the served ids}``."""
    worst = 0.0
    for s, r in zip(served, reference):
        if s["ids"].shape != r["best"].shape or s["scores"].shape != r["best"].shape:
            return {"answer_gap": math.inf}
        scale = r["best"].abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
        below = (r["best"] - r["of_served"]).clamp_min(0) / scale
        mismatch = (s["scores"] - r["of_served"]).abs() / scale
        worst = max(worst, _finite(float(torch.maximum(below, mismatch).max())))
    if len(served) != len(reference) or not served:
        return {"answer_gap": math.inf}
    return {"answer_gap": worst}


def verdict(numbers: Dict[str, float], limits: Dict[str, dict]) -> bool:
    return all(name in numbers and numbers[name] <= limits[name]["limit"] for name in limits)
