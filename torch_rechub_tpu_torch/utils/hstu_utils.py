"""HSTU / HLLM utilities: relative biases, time bucketization and vocab masking.

Counterpart of ``torch_rechub_tpu/utils/hstu_utils.py``: ``RelPosBias``
(the bucketed |i-j| bias of HLLM's blocks), ``bucketize_time``,
``RelativeBucketedTimeAndPositionBias`` (HSTU Eq.3 position table of
``2*maxL-1`` slots + time-difference bucket table) and ``apply_vocab_mask``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..basic.initializers import uniform_


class RelPosBias(nn.Module):
    """Bucketed |i-j| relative-position bias -> ``(1, H, L, L)``.

    The table ``rel_pos_bias_table (num_buckets, H)`` is U(±sqrt(1/num_buckets));
    the bucket of a pair is ``min(|i-j|, max_seq_len) * (num_buckets-1) //
    max_seq_len`` in integer arithmetic.
    """

    def __init__(self, n_heads: int, max_seq_len: int, num_buckets: int = 32, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.max_seq_len, self.num_buckets = max_seq_len, num_buckets
        self.rel_pos_bias_table = nn.Parameter(torch.empty(num_buckets, n_heads, device=device))
        uniform_(self.rel_pos_bias_table, math.sqrt(1.0 / num_buckets), generator)

    def forward(self, seq_len: int) -> torch.Tensor:
        pos = torch.arange(seq_len, device=self.rel_pos_bias_table.device)
        rel = torch.clamp_max((pos[None, :] - pos[:, None]).abs(), self.max_seq_len)
        buckets = rel * (self.num_buckets - 1) // self.max_seq_len
        return self.rel_pos_bias_table[buckets].permute(2, 0, 1)[None]  # (1, H, L, L)


def bucketize_time(dt: torch.Tensor, num_buckets: int, fn: str = "sqrt", divisor: float = 1.0, unit: str = "minutes", max_bucket: Optional[int] = None) -> torch.Tensor:
    """Map |seconds deltas| to int64 bucket indices (f32 arithmetic, as the reference)."""
    dt = dt.to(torch.float32).abs()
    if unit == "minutes":
        dt = dt / 60.0
    dt = torch.clamp_min(dt, 1e-6)
    b = torch.sqrt(dt) if fn == "sqrt" else torch.log(dt)
    hi = num_buckets if max_bucket is None else max_bucket
    return torch.clamp(b / divisor, 0, hi).to(torch.int64)


class RelativeBucketedTimeAndPositionBias(nn.Module):
    """HSTU ``rab^{p,t}``: a ``(2*max_seq_len-1, H)`` position table indexed by
    ``j - i + max_seq_len - 1`` and a ``(num_time_buckets+1, H)`` time table
    indexed by the bucketized pairwise |dt|.  ``forward`` returns the dense
    ``(B, H, L, L)`` bias with time, else ``(1, H, L, L)`` position-only."""

    def __init__(self, n_heads: int, max_seq_len: int, num_time_buckets: int = 128, time_bucket_fn: str = "sqrt", time_bucket_divisor: float = 1.0, time_bucket_unit: str = "minutes", generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if time_bucket_fn not in ("sqrt", "log"):
            raise ValueError(f"Unsupported time_bucket_fn: {time_bucket_fn}")
        self.max_seq_len = max_seq_len
        self.num_time_buckets = num_time_buckets
        self.time_bucket_fn = time_bucket_fn
        self.time_bucket_divisor = time_bucket_divisor
        self.time_bucket_unit = time_bucket_unit
        n_pos = 2 * max_seq_len - 1
        self.pos_w = nn.Parameter(torch.empty(n_pos, n_heads, device=device))
        uniform_(self.pos_w, math.sqrt(1.0 / n_pos), generator)
        self.ts_w = nn.Parameter(torch.empty(num_time_buckets + 1, n_heads, device=device))
        uniform_(self.ts_w, math.sqrt(1.0 / (num_time_buckets + 1)), generator)

    def tables(self):
        """The raw position / time tables, as the fused attention kernel takes them."""
        return self.pos_w, self.ts_w

    def forward(self, time_diffs: Optional[torch.Tensor] = None, seq_len: Optional[int] = None) -> torch.Tensor:
        if time_diffs is None:
            if seq_len is None:
                raise ValueError("Provide either `time_diffs` or `seq_len`.")
            length = seq_len
        else:
            length = time_diffs.shape[1]
        if length > self.max_seq_len:
            raise ValueError(f"seq_len ({length}) exceeds max_seq_len ({self.max_seq_len}).")
        pos = torch.arange(length, device=self.pos_w.device)
        rel_idx = pos[None, :] - pos[:, None] + (self.max_seq_len - 1)
        pos_bias = self.pos_w[rel_idx].permute(2, 0, 1)[None]  # (1, H, L, L)
        if time_diffs is None:
            return pos_bias
        dt_pair = time_diffs[:, :, None] - time_diffs[:, None, :]
        buckets = bucketize_time(dt_pair, self.num_time_buckets, self.time_bucket_fn, self.time_bucket_divisor, self.time_bucket_unit)
        return pos_bias + self.ts_w[buckets].permute(0, 3, 1, 2)  # (B, H, L, L)


def apply_vocab_mask(logits: torch.Tensor, static_invalid=None, invalid_ids=None, vocab_size: Optional[int] = None) -> torch.Tensor:
    """Suppress invalid / seen items in ``(..., V)`` scores with -1e9.

    Args:
        static_invalid: iterable of always-invalid token ids (e.g. ``[0]``).
        invalid_ids: per-row ``(B, N)`` (or 1-D, broadcast) ids; out-of-range
            ids fall back to id 0, like the reference's ``masked_fill(0)``.
    """
    v = vocab_size or logits.shape[-1]
    out = logits
    if static_invalid is not None:
        static = torch.zeros(v, dtype=torch.bool, device=logits.device)
        static[torch.as_tensor(list(static_invalid), dtype=torch.int64, device=logits.device)] = True
        out = out.masked_fill(static, -1e9)
    if invalid_ids is not None:
        invalid_ids = torch.as_tensor(invalid_ids, device=logits.device).to(torch.int64)
        if invalid_ids.ndim == 1:
            invalid_ids = invalid_ids[None, :].expand(out.shape[0], invalid_ids.shape[0])
        if out.ndim != 2 or invalid_ids.ndim != 2:
            raise ValueError("dynamic invalid_ids masking expects logits (B, V) and invalid_ids (B, N)")
        safe = torch.where((invalid_ids >= 0) & (invalid_ids < v), invalid_ids, torch.zeros_like(invalid_ids))
        out = out.scatter(1, safe, -1e9)
    return out
