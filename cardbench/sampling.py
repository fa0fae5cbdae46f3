"""Seeded draws on the card: sub-seeds, bounded power laws, lognormal gaps.

Every run makes its inputs and weights from ``--seed`` through these, in a
few large calls on a ``torch.Generator`` on the device, so one seed gives
the same inputs, whatever else the run does.
"""

from __future__ import annotations

import hashlib

import torch


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose (weights, data, the trainer's draws) of a run's ``--seed``."""
    digest = hashlib.sha256(f"{int(seed)}/{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, purpose))


def power_law_ranks(shape, n: int, exponent: float, gen: torch.Generator, device) -> torch.Tensor:
    """int64 ranks in ``[1, n]`` with ``P(r)`` close to ``r ** -exponent`` (the continuous law, inverted and floored)."""
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
    if exponent == 1.0:
        x = torch.exp(u * torch.log(torch.tensor(n + 1.0, dtype=torch.float64, device=device)))
    else:
        a = 1.0 - exponent
        x = (1.0 + u * ((n + 1.0) ** a - 1.0)) ** (1.0 / a)
    return torch.clamp(torch.floor(x), 1, n).to(torch.int64)


def lognormal(shape, median: float, sigma: float, gen: torch.Generator, device) -> torch.Tensor:
    """float64 draws with the given median and log-space standard deviation."""
    z = torch.randn(shape, generator=gen, device=device, dtype=torch.float64)
    return median * torch.exp(sigma * z)
