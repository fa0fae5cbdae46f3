"""The weights of a run, made on the card from its seed.

A configuration's kind lists its leaves as ``(name, shape, law, scale)`` in
the reference's names; ``make`` draws them in that order from one
``torch.Generator`` on the device, one call a leaf, so the same seed gives
the same weights whenever they are made again (the reference makes them
again after the window rather than holding a copy through it).
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

from .sampling import generator

Spec = Tuple[str, Tuple[int, ...], str, float]


def make(specs: Iterable[Spec], seed: int, device) -> Dict[str, torch.Tensor]:
    """``{name: float32 tensor}``: laws ``uniform`` (U(-scale, scale)), ``normal`` (N(0, scale^2)),
    ``const`` (filled with scale); a ``uniform_pad0`` table has its PAD row 0 zeroed."""
    gen = generator(seed, "weights", device)
    out = {}
    for name, shape, law, scale in specs:
        t = torch.empty(shape, device=device, dtype=torch.float32)
        if law in ("uniform", "uniform_pad0"):
            t.uniform_(-scale, scale, generator=gen)
            if law == "uniform_pad0":
                t[0] = 0.0
        elif law == "normal":
            t.normal_(0.0, scale, generator=gen)
        elif law == "const":
            t.fill_(scale)
        else:
            raise ValueError(f"unknown law {law!r} of {name}")
        out[name] = t
    return out
