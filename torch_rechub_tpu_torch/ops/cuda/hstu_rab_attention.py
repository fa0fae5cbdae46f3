"""HSTU silu attention with on-the-fly relative position/time bias (rab).

Counterpart of ``torch_rechub_tpu/ops/pallas/hstu_rab_attention.py``.  The
kernel receives only the small bias tables, ``pos_w (2*maxL-1, H)`` and
``ts_w (nb+1, H)``, the raw ``(B, L)`` timestamps and the integer bucket
thresholds, and rebuilds each bias element on the fly, so no ``(B, H, L, L)``
tensor is ever formed.

Replaces the TPU kernel ``ops/pallas/hstu_rab_attention.py:_fwd_kernel``
(K1) with ``csrc/hstu_rab_fwd.cu``, a CUDA C++ kernel for Hopper (sm_90a),
bound through ctypes.  At the serving shape the work is fp32 FMA-bound
(about 32 FLOP per byte of q/k/v/out, above the card's fp32 ridge of 20);
the kernel stages K/V tiles and the head's table columns in shared memory,
keeps the accumulator in registers and looks buckets up by binary search
over the thresholds; the source note has the details and what comes next.

Dispatch: a tensor on the CPU takes the plain PyTorch version
(:func:`dense_forward`, differentiable by autograd).  A tensor on a CUDA
device launches the kernel, or raises: there is no fallback.  The kernel
has no backward yet (the TPU's fused backward K2 comes with the training
slice), so differentiating through it raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ...utils.hstu_utils import bucketize_time
from . import _build

launches = 0  # kernel launches of this process; reset and read by chip_smoke.py

MAX_DV = 128
MAX_DQK = 256


class BucketCfg(NamedTuple):
    """Static time-bucketization config (mirrors ``bucketize_time``)."""

    num_buckets: int = 128
    fn: str = "sqrt"  # "sqrt" | "log"
    divisor: float = 1.0
    unit: str = "minutes"  # "minutes" | "seconds"


def _bucketize(dt: torch.Tensor, cfg: BucketCfg) -> torch.Tensor:
    return bucketize_time(dt, cfg.num_buckets, cfg.fn, cfg.divisor, cfg.unit)


def compute_bucket_thresholds(cfg: BucketCfg) -> torch.Tensor:
    """``thr[u]`` = smallest int ``|dt|`` with ``bucketize(dt) >= u``: int32 ``(nb+1,)`` on the CPU.

    ``bucketize`` is monotone in ``|dt|``, so ``bucket(dt) >= u`` holds
    exactly when ``|dt| >= thr[u]``; the kernel then finds a bucket as the
    largest ``u`` with ``thr[u] <= |dt|``, with no sqrt or log on the device.
    A 32-step bisection with ``bucketize`` itself as the predicate
    reproduces the f32 rounding at every edge.  Unreachable buckets get the
    int32-max sentinel.  ``log`` need not be monotone to the last ulp, so
    for ``fn="log"`` each threshold is repaired upward to the first of 64
    candidates that really reaches its bucket.
    """
    nbp1 = cfg.num_buckets + 1
    imax = torch.iinfo(torch.int32).max
    u = torch.arange(nbp1, dtype=torch.int64)
    lo = torch.zeros(nbp1, dtype=torch.int64)
    hi = torch.full((nbp1,), imax, dtype=torch.int64)  # invariant: the predicate holds at hi, if reachable
    for _ in range(32):
        mid = lo + (hi - lo) // 2
        ok = _bucketize(mid, cfg) >= u
        lo, hi = torch.where(ok, lo, mid + 1), torch.where(ok, mid, hi)
    reachable = _bucketize(torch.full((nbp1,), imax, dtype=torch.int64), cfg) >= u
    thr = torch.where(reachable, hi, torch.full_like(hi, imax))
    if cfg.fn != "sqrt":
        cand = torch.clamp_max(thr, imax - 64)[:, None] + torch.arange(64, dtype=torch.int64)[None, :]
        ok = _bucketize(cand, cfg) >= u[:, None]
        first = torch.where(ok, cand, torch.full_like(cand, imax)).min(dim=1).values
        thr = torch.where(reachable, first, torch.full_like(first, imax))
    thr[0] = 0
    return thr.to(torch.int32)


# ---------------------------------------------------------------------------
# plain PyTorch version (CPU path, tests, and the kernel's yardstick on the card)
# ---------------------------------------------------------------------------

def dense_bias(pos_w, ts_w, timestamps, l: int, max_seq_len: int, cfg: BucketCfg, has_time: bool) -> torch.Tensor:
    pos = torch.arange(l, device=pos_w.device)
    rel = pos[None, :] - pos[:, None] + (max_seq_len - 1)
    bias = pos_w[rel].permute(2, 0, 1)[None]  # (1, H, L, L)
    if has_time:
        dt = timestamps[:, :, None] - timestamps[:, None, :]
        bias = bias + ts_w[_bucketize(dt, cfg)].permute(0, 3, 1, 2)
    return bias


def dense_forward(q, k, v, pos_w, ts_w, timestamps, padding_mask, alpha: float, max_seq_len: int, cfg: BucketCfg, has_time: bool) -> torch.Tensor:
    """Materialised-bias reference: ``(B, H, L, dv)``."""
    l = q.shape[2]
    bias = dense_bias(pos_w, ts_w, timestamps, l, max_seq_len, cfg, has_time)
    scores = torch.einsum("bhld,bhmd->bhlm", q, k) * alpha + bias
    valid = torch.tril(torch.ones((l, l), dtype=torch.bool, device=q.device))[None, None]
    if padding_mask is not None:
        valid = valid & padding_mask[:, None, None, :]
    scores = scores.masked_fill(~valid, -1e4)
    attn = F.silu(scores) / max_seq_len
    return torch.einsum("bhlm,bhmd->bhld", attn, v.to(attn.dtype)).to(q.dtype)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    lib = _build.load("hstu_rab_fwd")
    if lib.hstu_rab_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.hstu_rab_fwd.argtypes = [p] * 9 + [i] * 7 + [ctypes.c_float, p]
        lib.hstu_rab_fwd.restype = i
        lib.hstu_rab_error_string.argtypes = [i]
        lib.hstu_rab_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_inputs(q, k, v, pos_w, ts_w, timestamps, padding_mask, thresholds, max_seq_len, num_buckets):
    b, h, l, dqk = q.shape
    dv = v.shape[-1]
    dev = q.device
    named = {"q": q, "k": k, "v": v, "pos_w": pos_w, "ts_w": ts_w, "thresholds": thresholds, "timestamps": timestamps, "padding_mask": padding_mask}
    for name, t in named.items():
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"hstu_attention_rab: {name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"hstu_attention_rab: {name} must be contiguous")
    for name in ("q", "k", "v", "pos_w", "ts_w"):
        if named[name].dtype != torch.float32:
            raise TypeError(f"hstu_attention_rab: the CUDA kernel takes float32, got {name} {named[name].dtype}")
    if k.shape != q.shape or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"hstu_attention_rab: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if tuple(pos_w.shape) != (2 * max_seq_len - 1, h) or tuple(ts_w.shape) != (num_buckets + 1, h):
        raise ValueError(f"hstu_attention_rab: tables {tuple(pos_w.shape)}, {tuple(ts_w.shape)} for max_seq_len {max_seq_len}, {num_buckets} buckets, {h} heads")
    if thresholds.dtype != torch.int32 or tuple(thresholds.shape) != (num_buckets + 1,):
        raise ValueError("hstu_attention_rab: thresholds must be int32 of shape (num_buckets+1,)")
    if timestamps is not None and (timestamps.dtype != torch.int32 or tuple(timestamps.shape) != (b, l)):
        raise ValueError("hstu_attention_rab: timestamps must be int32 (B, L)")
    if padding_mask is not None and (padding_mask.dtype != torch.bool or tuple(padding_mask.shape) != (b, l)):
        raise ValueError("hstu_attention_rab: padding_mask must be bool (B, L)")
    if not (1 <= dv <= MAX_DV and 1 <= dqk <= MAX_DQK):
        raise ValueError(f"hstu_attention_rab: the CUDA kernel takes dv <= {MAX_DV} and dqk <= {MAX_DQK}, got dqk={dqk} dv={dv}")
    if b * h > 65535:
        raise ValueError(f"hstu_attention_rab: B*H = {b * h} exceeds the grid limit 65535")


def _launch(q, k, v, pos_w, ts_w, timestamps, padding_mask, thresholds, alpha: float, max_seq_len: int) -> torch.Tensor:
    global launches
    num_buckets = ts_w.shape[0] - 1
    _check_kernel_inputs(q, k, v, pos_w, ts_w, timestamps, padding_mask, thresholds, max_seq_len, num_buckets)
    b, h, l, dqk = q.shape
    dv = v.shape[-1]
    out = torch.empty((b, h, l, dv), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.hstu_rab_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_w.data_ptr(), ts_w.data_ptr(), thresholds.data_ptr(),
            None if timestamps is None else timestamps.data_ptr(), None if padding_mask is None else padding_mask.data_ptr(),
            out.data_ptr(), b, h, l, dqk, dv, max_seq_len, num_buckets, float(alpha), stream,
        )
    if rc != 0:
        raise RuntimeError(f"hstu_rab_fwd launch failed: {lib.hstu_rab_error_string(rc).decode()} (B={b} H={h} L={l} dqk={dqk} dv={dv})")
    launches += 1
    return out


class _RabAttentionKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, pos_w, ts_w, timestamps, padding_mask, thresholds, alpha, max_seq_len):
        return _launch(q, k, v, pos_w, ts_w, timestamps, padding_mask, thresholds, alpha, max_seq_len)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "hstu_attention_rab has no CUDA backward yet: the TPU's fused backward kernel "
            "(ops/pallas/hstu_rab_attention.py:_bwd_fused_kernel, K2) is ported with the training slice"
        )


def hstu_attention_rab(q, k, v, pos_w, ts_w, timestamps, padding_mask, alpha: float, max_seq_len: int, cfg: BucketCfg, thresholds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """HSTU attention with on-the-fly rab^{p,t} bias.

    Args:
        q, k: ``(B, H, L, dqk)``; v: ``(B, H, L, dv)``.
        pos_w: ``(2*max_seq_len-1, H)`` position table.
        ts_w: ``(num_buckets+1, H)`` time-bucket table.
        timestamps: ``(B, L)`` int per-position times, or None (position only).
        padding_mask: ``(B, L)`` bool, True = valid key; None = all valid.
        thresholds: ``compute_bucket_thresholds(cfg)`` already on q's device
            (a layer keeps it as a buffer); computed here when None.

    Returns ``(B, H, L, dv)``.
    """
    l = q.shape[2]
    if l > max_seq_len:
        raise ValueError(f"seq_len ({l}) exceeds max_seq_len ({max_seq_len}).")
    has_time = timestamps is not None
    if q.device.type == "cpu":
        return dense_forward(q, k, v, pos_w, ts_w, timestamps, padding_mask, alpha, max_seq_len, cfg, has_time)
    if q.device.type != "cuda":
        raise ValueError(f"hstu_attention_rab runs on the CPU (plain version) or a CUDA device (kernel), not {q.device}")
    if ts_w.shape[0] != cfg.num_buckets + 1:
        raise ValueError(f"hstu_attention_rab: ts_w has {ts_w.shape[0]} rows, cfg {cfg.num_buckets + 1}")
    if thresholds is None:
        thresholds = compute_bucket_thresholds(cfg).to(q.device)
    if has_time:
        timestamps = timestamps.to(torch.int32).contiguous()
    return _RabAttentionKernel.apply(q, k, v, pos_w, ts_w, timestamps, padding_mask, thresholds, alpha, max_seq_len)
