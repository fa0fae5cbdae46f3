"""What the program's own state says after its first step: the gradient each optimizer took.

Adam's first moment after one step is ``(1 - beta1)`` times the gradient it
was given (weight decay included); a row-wise Adagrad accumulator after one
step holds each touched row's mean squared gradient, so ``D`` times its sum
is the table gradient's squared norm.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def first_grad_norms(trainer) -> Dict[str, float]:
    """``{parameter name: norm}`` of the gradient each leaf's optimizer took on the step just taken (the first)."""
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    out = {}
    for opt in getattr(trainer.optimizer, "optimizers", [trainer.optimizer]):
        for group in opt.param_groups:
            beta1 = group["betas"][0]
            for p in group["params"]:
                state = opt.state.get(p, {})
                if "exp_avg" in state:
                    out[names[id(p)]] = float(torch.linalg.vector_norm(state["exp_avg"])) / (1.0 - beta1)
    for name, acc in trainer.sparse_accums.items():
        out[name] = math.sqrt(trainer.sparse_tables[name].shape[1] * float(acc.double().sum()))
    return out
