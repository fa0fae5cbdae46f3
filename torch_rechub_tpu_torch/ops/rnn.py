"""A GRU over post-padded sequences whose hidden state is frozen under the mask.

Counterpart of ``torch_rechub_tpu/ops/rnn.py``.  The JAX package runs the
recurrence as one ``lax.scan``; here it is a Python loop over the L steps
on the tensors of the batch (about a dozen kernels a step).  It is not
``nn.GRU`` on an unpacked batch: at a padded step the state is kept and
the output is zero, so the final state is that of the last valid step, as
``pack_padded_sequence`` gives for post-padded rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..basic.initializers import param


class GRULayer(nn.Module):
    """One GRU layer (torch's gate equations) returning ``(outputs (B, L, d), final_h (B, d))``.

    The JAX package's layout: ``w_i (in, 3d)``, ``w_h (d, 3d)``, ``b_i``,
    ``b_h (3d,)``, gates in the order r | z | n, and
    ``n = tanh(W_in x + b_in + r ⊙ (W_hn h + b_hn))``.  Every parameter is
    drawn from U(-1/sqrt(d), 1/sqrt(d)).  ``mask (B, L)`` freezes the state
    at steps where it is 0 and zeroes their outputs; ``mask=None`` runs
    every step.
    """

    def __init__(self, in_features: int, hidden: int, use_bias: bool = True, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        bound = 1.0 / hidden**0.5

        def init(shape, gen=None):
            return torch.empty(shape).uniform_(-bound, bound, generator=gen)

        self.hidden, self.use_bias = hidden, use_bias
        self.w_i = param(init, (in_features, 3 * hidden), generator, device)
        self.w_h = param(init, (hidden, 3 * hidden), generator, device)
        if use_bias:
            self.b_i = param(init, (3 * hidden,), generator, device)
            self.b_h = param(init, (3 * hidden,), generator, device)

    def forward(self, seq: torch.Tensor, mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        b, l, _ = seq.shape
        gi = seq @ self.w_i  # (B, L, 3d): the input side of every step at once
        if self.use_bias:
            gi = gi + self.b_i
        h = seq.new_zeros(b, self.hidden)
        keep = None if mask is None else (mask > 0)[..., None]  # (B, L, 1)
        outs = []
        for t in range(l):
            gh = h @ self.w_h
            if self.use_bias:
                gh = gh + self.b_h
            ir, iz, inn = gi[:, t].chunk(3, dim=-1)
            hr, hz, hn = gh.chunk(3, dim=-1)
            r = torch.sigmoid(ir + hr)
            z = torch.sigmoid(iz + hz)
            h_new = (1 - z) * torch.tanh(inn + r * hn) + z * h
            if keep is None:
                h = h_new
                outs.append(h_new)
            else:
                h = torch.where(keep[:, t], h_new, h)
                outs.append(torch.where(keep[:, t], h_new, torch.zeros_like(h_new)))
        return torch.stack(outs, dim=1), h
