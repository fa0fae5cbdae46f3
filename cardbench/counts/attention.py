"""Operations and bytes of the HSTU attention kernels, and their least time on one H100.

A frozen copy of the bound arithmetic the port's kernel checks use
(``valid_pairs``, ``bound``, ``both_bounds``, ``rab_bound``, ``bwd_bound``),
taken from shapes instead of tensors so that it needs no run:

- operations are counted over the valid (query, key) pairs: key ``m`` at or
  before query ``l``, key unmasked, in every head;
- every input byte is read once and every output byte written once;
- the tensor-core kernels run each product as 3xTF32 (three TF32 passes),
  so their operation bound is three times the FLOPs at the TF32 peak.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .peaks import PEAK_FP32_FLOPS, PEAK_HBM_BYTES, PEAK_TF32_FLOPS, TF32_PASSES

# FMAs per valid pair and head width of each backward kernel: (per dqk, per dv)
BWD_FMA = {"hstu_rab_bwd": (3, 2), "hstu_rab_bwd_dq": (2, 1), "hstu_rab_bwd_dkv": (2, 2)}


def valid_pairs(b: int, h: int, l: int, lengths: Optional[Sequence[int]] = None) -> int:
    """(query, key) pairs the kernels need, over all heads: ``m <= l`` with key ``m`` unmasked.

    ``lengths``: each row's unmasked prefix (suffix padding); None means full rows.
    """
    lengths = [l] * b if lengths is None else list(lengths)
    return h * sum(n * (n + 1) // 2 + n * (l - n) for n in lengths)


def mask_pairs(valid) -> list:
    """One head's valid pairs of each batch of a ``(..., B, L)`` bool mask of unmasked keys, as ``valid_pairs`` counts them, whatever the padding."""
    import torch

    return torch.cumsum(valid.to(torch.int64), dim=-1).sum(dim=(-2, -1)).reshape(-1).tolist()


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS):
    """``(bound ms, what bounds it)``: FLOPs at ``peak`` against bytes at the HBM rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def both_bounds(flops: float, nbytes: float, tensor_core: bool = True) -> dict:
    """The fp32-FMA bound and, for a tensor-core kernel, the 3xTF32 one, which is then the reported least time."""
    fp32 = bound(flops, nbytes)
    tensor = bound(TF32_PASSES * flops, nbytes, PEAK_TF32_FLOPS) if tensor_core else None
    least = tensor or fp32
    return dict(fp32=fp32, tensor=tensor, bound_ms=least[0], bound_by=least[1], flops=flops, bytes=nbytes)


def input_bytes(b: int, h: int, l: int, dqk: int, dv: int, max_seq_len: int, num_buckets: int, has_time: bool = True, has_mask: bool = True) -> int:
    """The kernel's fp32 inputs: q, k, v, the position and time tables, int32 stamps, a bool mask, int32 bucket edges."""
    qkv = 4 * b * h * l * (2 * dqk + dv)
    tables = 4 * h * (2 * max_seq_len - 1) + 4 * h * (num_buckets + 1)
    stamps = 4 * b * l if has_time else 0
    mask = b * l if has_mask else 0
    thresholds = 4 * (num_buckets + 1)
    return qkv + tables + stamps + mask + thresholds


def rab_bound(b: int, h: int, l: int, dqk: int, dv: int, max_seq_len: int, num_buckets: int, pairs: Optional[int] = None, has_time: bool = True, has_mask: bool = True) -> dict:
    """K1: 2 (dqk + dv) FLOP per valid pair; inputs read and the output written once."""
    pairs = valid_pairs(b, h, l) if pairs is None else pairs
    nbytes = input_bytes(b, h, l, dqk, dv, max_seq_len, num_buckets, has_time, has_mask) + 4 * b * h * l * dv
    return both_bounds(2 * pairs * (dqk + dv), nbytes)


def bwd_outputs(b: int, h: int, l: int, dqk: int, dv: int, max_seq_len: int, num_buckets: int, kernel: str) -> int:
    dq = 4 * b * h * l * dqk
    dk, dvv = dq, 4 * b * h * l * dv
    tables = 4 * h * (2 * max_seq_len - 1) + 4 * h * (num_buckets + 1)
    return {"hstu_rab_bwd": dq + dk + dvv + tables, "hstu_rab_bwd_dq": dq + tables, "hstu_rab_bwd_dkv": dk + dvv}[kernel]


def bwd_bound(b: int, h: int, l: int, dqk: int, dv: int, max_seq_len: int, num_buckets: int, kernel: str = "hstu_rab_bwd", pairs: Optional[int] = None, has_time: bool = True, has_mask: bool = True) -> dict:
    """A backward kernel: its FMAs per valid pair; inputs and the output gradient read, its outputs written once."""
    pairs = valid_pairs(b, h, l) if pairs is None else pairs
    fq, fv = BWD_FMA[kernel]
    nbytes = input_bytes(b, h, l, dqk, dv, max_seq_len, num_buckets, has_time, has_mask) + 4 * b * h * l * dv + bwd_outputs(b, h, l, dqk, dv, max_seq_len, num_buckets, kernel)
    return both_bounds(2 * pairs * (fq * dqk + fv * dv), nbytes)
