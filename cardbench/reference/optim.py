"""Plain optimizer updates of the reference, written out."""

from __future__ import annotations

import torch

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def adam_step(p: torch.Tensor, g: torch.Tensor, state: dict, step: int, lr: float, weight_decay: float) -> torch.Tensor:
    """Adam with the weight decay added to the gradient, in place; returns that gradient."""
    g = g + weight_decay * p
    m = state["m"] = BETA1 * state.get("m", torch.zeros_like(p)) + (1 - BETA1) * g
    v = state["v"] = BETA2 * state.get("v", torch.zeros_like(p)) + (1 - BETA2) * g * g
    m_hat = m / (1 - BETA1**step)
    v_hat = v / (1 - BETA2**step)
    p -= lr * m_hat / (torch.sqrt(v_hat) + EPS)
    return g


def rowwise_adagrad_step(table: torch.Tensor, accum: torch.Tensor, g: torch.Tensor, lr: float, eps: float = 1e-10) -> None:
    """Row-wise Adagrad from a dense ``(R, D)`` gradient, in place: each row with a gradient
    adds its mean square to its accumulator, then moves by ``lr / (sqrt(acc) + eps)`` times it."""
    touched = (g != 0).any(dim=1)
    accum += torch.where(touched, (g * g).mean(dim=1), torch.zeros_like(accum))
    scale = torch.where(touched, lr / (torch.sqrt(accum) + eps), torch.zeros_like(accum))
    table -= scale[:, None] * g
