"""Faults planted in the expert layers underneath the timed path, which the comparison has to catch.

Each takes the program's trainer and changes every expert layer
(``basic/moe.py`` ``MoE``) of its model in place:

- ``capacity``: tokens dropped beyond a capacity of 1.0 times the mean load,
  as a capacity-factor dispatch does: each held expert keeps its first
  ``ceil(pairs / experts held)`` pairs (in token order) and drops the rest;
- ``top5``: the router keeps its top 5 experts instead of its top 6.
"""

from __future__ import annotations

import math

import torch


def _expert_layers(trainer):
    return [m for m in trainer.model.modules() if hasattr(m, "select_pairs") and hasattr(m, "gate")]


def capacity(trainer) -> None:
    for layer in _expert_layers(trainer):
        select = layer.select_pairs

        def capped(ids, weights, valid, select=select):
            tok, w, counts = select(ids, weights, valid)
            cap = math.ceil(sum(counts) / len(counts))
            keep, start = [], 0
            for c in counts:
                keep.append(torch.arange(start, start + min(c, cap), device=tok.device))
                start += c
            kept = torch.cat(keep)
            return tok[kept], w[kept], [min(c, cap) for c in counts]

        layer.select_pairs = capped


def top5(trainer) -> None:
    for layer in _expert_layers(trainer):
        layer.gate.top_k -= 1


MOE = {"capacity": capacity, "top5": top5}
