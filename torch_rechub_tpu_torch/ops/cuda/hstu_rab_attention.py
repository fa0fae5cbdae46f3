"""HSTU silu attention with on-the-fly relative position/time bias (rab).

Counterpart of ``torch_rechub_tpu/ops/pallas/hstu_rab_attention.py``.  The
kernels receive only the small bias tables, ``pos_w (2*maxL-1, H)`` and
``ts_w (nb+1, H)``, the raw ``(B, L)`` timestamps and the integer bucket
thresholds, and rebuild each bias element on the fly, so no ``(B, H, L, L)``
tensor is ever formed, forward or backward.

Kernels, CUDA C++ for Hopper (sm_90a), bound through ctypes:

- forward, ``csrc/hstu_rab_fwd.cu``, replaces the TPU's ``_fwd_kernel`` (K1):
  products on the tensor cores in 3xTF32 (fp32 accuracy), the next K/V tile
  copied with ``cp.async`` during the current one's math, P kept in
  registers, and the bucket found in O(1) (:func:`bucket_lookup` is its
  plain version).
- backward, ``csrc/hstu_rab_bwd.cu``: ``hstu_rab_bwd`` replaces the fused
  ``_bwd_fused_kernel`` (K2, the default), ``hstu_rab_bwd_dq`` and
  ``hstu_rab_bwd_dkv`` the split pair ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``
  (K2a per q tile, K2b per key tile), taken when ``_FUSED_BWD[0]`` is False
  (as in the JAX package) or deterministic algorithms are on.  All three
  are built as K1 is: 3xTF32 products, P and dS in registers, ``cp.async``
  rings.  The source notes have the designs.  dpos and dts are summed in a
  fixed order (per-warp sums added in warp order, then the CTAs' slices of
  a scratch buffer added in CTA order by a second small kernel): the same
  bit for bit from run to run, in K2 and K2a alike.
- any width, and any L: where a tensor-core kernel does not take the shape
  (forward dv > 128 or dqk > 256, backward dqk or dv > 128, or shared memory
  beyond the SM's at a long L) the same entry launches its width-tiled
  variant (``csrc/hstu_wide.cuh``: 64-column output chunks over the grid,
  the scores K-looped over the full width, fp32 FMAs), which takes every
  shape; K2's is K2a's variant then K2b's.  ``launches_wide`` counts them.
- bf16 (the mixed-precision policy, ``basic/precision.py``):
  ``csrc/hstu_rab_fwd_bf16.cu`` (K1) and ``csrc/hstu_rab_bwd_bf16.cu`` (K2,
  and the split pair K2a, K2b) take bf16 q, k, v and g with f32 tables,
  multiply on the tensor cores in ``mma.sync.m16n8k16`` bf16 with f32
  accumulators (K1, K2 and K2b in their fp32 twins' Hopper design: 8-warp
  CTAs, ``cp.async`` rings, K2's dq by vector reductions), and round where
  the Pallas kernels round: the forward's
  ``attn`` to bf16 before ``attn @ v`` and its output to bf16; the
  backward's ``attn`` and ``ds`` to bf16 before the dv, dk and dq products,
  dq summed in f32 and rounded at the end (K2 into an f32 buffer, K2a in
  registers), dk and dv written in bf16, dpos and dts summed in f32 from
  the unrounded ``ds``.

Dispatch: a tensor on the CPU takes the plain PyTorch versions
(fp32: :func:`dense_forward`, differentiable by autograd, and
:func:`dense_backward`; bf16: :func:`plain_forward_bf16` and
:func:`plain_backward_bf16`, at the kernels' rounding points).  A tensor on
a CUDA device launches the kernels, or raises: there is no fallback and no
cast between the two precisions.

The forward is the registered op ``torch.ops.rechub.hstu_rab_fwd``
(:func:`rab_forward`, with a fake version for tracing), so ``torch.export``
records K1 as one call.  A forward that needs no gradient calls the op
alone; a training forward calls it inside ``_RabAttentionKernel``, whose
backward launches K2 or K2a + K2b (on the CPU in fp32, autograd of the
plain version, as before).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from ...utils.hstu_utils import bucketize_time
from . import _build

# kernel launches of this process, one count per kernel; reset and read by chip_smoke.py
launches = 0  # K1, hstu_rab_fwd
launches_bwd = 0  # K2, hstu_rab_bwd
launches_bwd_dq = 0  # K2a, hstu_rab_bwd_dq
launches_bwd_dkv = 0  # K2b, hstu_rab_bwd_dkv
launches_bf16 = 0  # K1 in bf16, hstu_rab_fwd_bf16
launches_bwd_bf16 = 0  # K2 in bf16, hstu_rab_bwd_bf16
launches_bwd_dq_bf16 = 0  # K2a in bf16, hstu_rab_bwd_dq_bf16
launches_bwd_dkv_bf16 = 0  # K2b in bf16, hstu_rab_bwd_dkv_bf16
launches_wide = {}  # entry name -> launches that took the width-tiled variant (each also counts on the entry's own count)

_FUSED_BWD = [True]  # False takes the split pair K2a + K2b (the JAX package's A/B switch)

WIDE = "width-tiled"  # the variant a shape takes, as the occupancy queries report it; else TENSOR_CORE
TENSOR_CORE = "tensor-core"
# K2's and K2a's dts sums keep a table of num_buckets + 1 floats in shared memory, one at least beside the
# width-tiled variant's 51,200 bytes of tiles: 232,448 bytes an SM's CTA may take hold 45,312 (hstu_wide.cuh)
MAX_BWD_BUCKETS = 45_311


def _count_wide(name: str, taken) -> None:
    if taken.value:
        launches_wide[name] = launches_wide.get(name, 0) + 1


class BucketCfg(NamedTuple):
    """Static time-bucketization config (mirrors ``bucketize_time``)."""

    num_buckets: int = 128
    fn: str = "sqrt"  # "sqrt" | "log"
    divisor: float = 1.0
    unit: str = "minutes"  # "minutes" | "seconds"


def _bucketize(dt: torch.Tensor, cfg: BucketCfg) -> torch.Tensor:
    return bucketize_time(dt, cfg.num_buckets, cfg.fn, cfg.divisor, cfg.unit)


def bucket_codes(cfg: BucketCfg):
    """``(fn_log, minutes, divisor)``: the bucket config as the kernels take it."""
    return int(cfg.fn != "sqrt"), int(cfg.unit == "minutes"), float(cfg.divisor)


def bucket_lookup(dt: torch.Tensor, thresholds: torch.Tensor, cfg: BucketCfg) -> torch.Tensor:
    """The kernels' bucket lookup in plain PyTorch: int64 buckets of int32 differences ``dt``.

    A guess from the f32 steps of :func:`bucketize_time`, then moved up while
    ``thr[u+1] <= |dt|`` and down while ``thr[u] > |dt|``: the largest ``u``
    with ``thr[u] <= |dt|``, exactly, whatever the guess's rounding.  ``|dt|``
    (up to 2**31 for a wrapped difference) is clamped to 2**31 - 2, which has
    the same f32 value and lies below the int32-max sentinel of the buckets
    no ``|dt|`` reaches.
    """
    imax = torch.iinfo(torch.int32).max
    a = dt.to(torch.int64).abs().clamp_max(imax - 1)
    x = a.to(torch.float32)
    if cfg.unit == "minutes":
        x = x / 60.0
    x = torch.clamp_min(x, 1e-6)
    x = torch.sqrt(x) if cfg.fn == "sqrt" else torch.log(x)
    u = torch.clamp(x / cfg.divisor, 0, cfg.num_buckets).to(torch.int64)
    thr = thresholds.to(device=dt.device, dtype=torch.int64)
    nb = cfg.num_buckets
    while True:
        up = (u < nb) & (thr[torch.clamp_max(u + 1, nb)] <= a)
        if not bool(up.any()):
            break
        u = u + up.to(torch.int64)
    while True:
        down = thr[u] > a
        if not bool(down.any()):
            break
        u = u - down.to(torch.int64)
    return u


def compute_bucket_thresholds(cfg: BucketCfg) -> torch.Tensor:
    """``thr[u]`` = smallest int ``|dt|`` with ``bucketize(dt) >= u``: int32 ``(nb+1,)`` on the CPU.

    ``bucketize`` is monotone in ``|dt|``, so ``bucket(dt) >= u`` holds
    exactly when ``|dt| >= thr[u]``; the kernels find a bucket as the
    largest ``u`` with ``thr[u] <= |dt|`` (:func:`bucket_lookup`).
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


# every config of the lookup that the bucket sweep covers: sqrt / log, minutes / seconds, divisor 1 / 2
SWEEP_CFGS = tuple(BucketCfg(128, fn, div, unit) for fn in ("sqrt", "log") for unit in ("minutes", "seconds") for div in (1.0, 2.0))


def bucket_sweep_stamps(cfg: BucketCfg, seed: int = 0) -> torch.Tensor:
    """``(2, L)`` int32 stamps that drive the bucket lookup over every edge of ``cfg``.

    Row 0: ``t_0 = 0`` and, for each other position, one of the differences
    ``thr[u] - 1``, ``thr[u]``, ``thr[u] + 1`` of every reachable threshold,
    with a random sign, so ``|t_l - t_0|`` hits each of them.  Row 1: stamps
    at both ends of int32, whose wrapping differences reach ``|dt| = 2**31``.
    ``L`` is one more than the number of such differences.
    """
    thr = compute_bucket_thresholds(cfg).to(torch.int64)
    edges = thr[thr < torch.iinfo(torch.int32).max]
    diffs = torch.unique(torch.cat([edges - 1, edges, edges + 1]).clamp(0, 2**31 - 1))
    gen = torch.Generator().manual_seed(seed)
    sign = torch.where(torch.rand(diffs.numel(), generator=gen) < 0.5, -1, 1)
    row0 = torch.cat([torch.zeros(1, dtype=torch.int64), sign * diffs])
    ends = torch.tensor([-(2**31), -(2**31) + 1, 0, 1, 2**31 - 1, 2**31 - 2])
    row1 = ends[torch.randint(0, ends.numel(), (row0.numel(),), generator=gen)]
    return torch.stack([row0, row1]).to(torch.int32)


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


def _bf16_scores(q, k, pos_w, ts_w, timestamps, padding_mask, alpha: float, max_seq_len: int, cfg: BucketCfg, has_time: bool):
    """f32 scores of bf16 ``q``, ``k`` (exact products, f32 sums), masked pairs at -1e4; and the valid pairs."""
    l = q.shape[2]
    bias = dense_bias(pos_w, ts_w, timestamps, l, max_seq_len, cfg, has_time)
    scores = torch.einsum("bhld,bhmd->bhlm", q.float(), k.float()) * alpha + bias
    valid = torch.tril(torch.ones((l, l), dtype=torch.bool, device=q.device))[None, None]
    if padding_mask is not None:
        valid = valid & padding_mask[:, None, None, :]
    return scores.masked_fill(~valid, -1e4), valid


def plain_forward_bf16(q, k, v, pos_w, ts_w, timestamps, padding_mask, alpha: float, max_seq_len: int, cfg: BucketCfg, has_time: bool) -> torch.Tensor:
    """K1 on bf16 inputs as the Pallas kernel rounds: ``(B, H, L, dv)`` bf16.

    Scores in f32; ``attn = silu(s) / N`` rounded to bf16 before the f32
    ``attn @ v``; the output rounded to bf16.  (The JAX package's dense
    fallback rounds ``q @ k`` instead and keeps ``attn`` in f32.)
    """
    s, _ = _bf16_scores(q, k, pos_w, ts_w, timestamps, padding_mask, alpha, max_seq_len, cfg, has_time)
    attn = (s * torch.sigmoid(s) * (1.0 / max_seq_len)).to(torch.bfloat16)
    return torch.einsum("bhlm,bhmd->bhld", attn.float(), v.float()).to(torch.bfloat16)


def plain_backward_bf16(q, k, v, g, pos_w, ts_w, timestamps, padding_mask, alpha: float, max_seq_len: int, cfg: BucketCfg, has_time: bool):
    """K2 on bf16 inputs as the Pallas kernel rounds: ``(dq, dk, dv)`` bf16, ``(dpos, dts)`` f32.

    ``attn`` and ``ds`` are rounded to bf16 for the dv, dk and dq products
    (f32 sums); dpos and dts sum the unrounded f32 ``ds``.
    """
    b, h, l, _ = q.shape
    s, valid = _bf16_scores(q, k, pos_w, ts_w, timestamps, padding_mask, alpha, max_seq_len, cfg, has_time)
    inv_n = 1.0 / max_seq_len
    sig = torch.sigmoid(s)
    attn = (s * sig) * inv_n
    gf = g.float()
    dattn = torch.einsum("bhld,bhmd->bhlm", gf, v.float())
    ds = torch.where(valid, dattn * (sig * (1.0 + s * (1.0 - sig))) * inv_n, torch.zeros_like(s))
    a16, d16 = attn.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
    dv = torch.einsum("bhlm,bhld->bhmd", a16, gf).to(torch.bfloat16)
    dk = (torch.einsum("bhlm,bhld->bhmd", d16, q.float()) * alpha).to(torch.bfloat16)
    dq = (torch.einsum("bhlm,bhmd->bhld", d16, k.float()) * alpha).to(torch.bfloat16)
    pos = torch.arange(l, device=q.device)
    rel = (pos[None, :] - pos[:, None] + (max_seq_len - 1)).reshape(-1)
    dpos = torch.zeros_like(pos_w).index_add_(0, rel, ds.sum(0).permute(1, 2, 0).reshape(l * l, h))
    dts = torch.zeros_like(ts_w)
    if has_time:
        buckets = _bucketize(timestamps[:, :, None] - timestamps[:, None, :], cfg).reshape(-1)
        dts.index_add_(0, buckets, ds.permute(0, 2, 3, 1).reshape(b * l * l, h))
    return dq, dk, dv, dpos, dts


def dense_backward(q, k, v, g, pos_w, ts_w, timestamps, padding_mask, alpha: float, max_seq_len: int, cfg: BucketCfg, has_time: bool):
    """``(dq, dk, dv, dpos, dts)``: autograd of :func:`dense_forward` against ``g``.

    The plain version of all three backward kernels; each is held against
    its subset.  ``dts`` is zeros when ``has_time`` is False, as JAX's vjp gives.
    """
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v, pos_w, ts_w)]
        out = dense_forward(*leaves, timestamps, padding_mask, alpha, max_seq_len, cfg, has_time)
        grads = torch.autograd.grad(out, leaves, g, allow_unused=True)
    return tuple(torch.zeros_like(t) if d is None else d for t, d in zip(leaves, grads))


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _load_fwd(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i] * 7 + [ctypes.c_float, i, i, ctypes.c_float, p, p]  # ..., stream, taken
        fn.restype = i
        occ = getattr(lib, name + "_occupancy")
        occ.argtypes = [i] * 5 + [p]
        occ.restype = i
        lib.hstu_rab_error_string.argtypes = [i]
        lib.hstu_rab_error_string.restype = ctypes.c_char_p
    return lib


def _lib() -> ctypes.CDLL:
    return _load_fwd("hstu_rab_fwd")


def _lib_bf16() -> ctypes.CDLL:
    return _load_fwd("hstu_rab_fwd_bf16")


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
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"hstu_attention_rab: the CUDA kernels take q, k, v all float32 or all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    for name in ("pos_w", "ts_w"):
        if named[name].dtype != torch.float32:
            raise TypeError(f"hstu_attention_rab: the CUDA kernels take float32 tables, got {name} {named[name].dtype}")
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
    if b * h > 65535:
        raise ValueError(f"hstu_attention_rab: B*H = {b * h} exceeds the grid limit 65535")


def _launch(q, k, v, pos_w, ts_w, timestamps, padding_mask, thresholds, alpha: float, max_seq_len: int, cfg: BucketCfg) -> torch.Tensor:
    """K1, or its bf16 variant when q is bf16: the output in q's dtype."""
    global launches, launches_bf16
    num_buckets = ts_w.shape[0] - 1
    _check_kernel_inputs(q, k, v, pos_w, ts_w, timestamps, padding_mask, thresholds, max_seq_len, num_buckets)
    b, h, l, dqk = q.shape
    dv = v.shape[-1]
    bf16 = q.dtype == torch.bfloat16
    name = "hstu_rab_fwd_bf16" if bf16 else "hstu_rab_fwd"
    out = torch.empty((b, h, l, dv), dtype=q.dtype, device=q.device)
    lib = _lib_bf16() if bf16 else _lib()
    taken = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_w.data_ptr(), ts_w.data_ptr(), thresholds.data_ptr(),
            None if timestamps is None else timestamps.data_ptr(), None if padding_mask is None else padding_mask.data_ptr(),
            out.data_ptr(), b, h, l, dqk, dv, max_seq_len, num_buckets, float(alpha), *bucket_codes(cfg), stream, ctypes.byref(taken),
        )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {lib.hstu_rab_error_string(rc).decode()} (B={b} H={h} L={l} dqk={dqk} dv={dv})")
    _count_wide(name, taken)
    if bf16:
        launches_bf16 += 1
    else:
        launches += 1
    return out


BWD_ENTRIES = ("hstu_rab_bwd", "hstu_rab_bwd_dq", "hstu_rab_bwd_dkv")  # K2, K2a, K2b: the C occupancy query's index
BWD_ENTRIES_BF16 = tuple(name + "_bf16" for name in BWD_ENTRIES)


def _load_bwd(name: str, entries) -> ctypes.CDLL:
    """The backward library ``name``, its ``entries`` (K2, K2a, K2b, in the occupancy query's order) bound."""
    lib = _build.load(name)
    if getattr(lib, entries[0]).argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (getattr(lib, entry) for entry in entries):
            fn.argtypes = [p] * 15 + [i] * 7 + [ctypes.c_float, i, i, ctypes.c_float, p, p]  # ..., dts, scratch, ..., stream, taken
            fn.restype = i
        occ = getattr(lib, name + "_occupancy")
        occ.argtypes = [i] * 6 + [p]
        occ.restype = i
        lib.hstu_rab_bwd_error_string.argtypes = [i]
        lib.hstu_rab_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _lib_bwd_bf16() -> ctypes.CDLL:
    return _load_bwd("hstu_rab_bwd_bf16", BWD_ENTRIES_BF16)


def _lib_bwd() -> ctypes.CDLL:
    return _load_bwd("hstu_rab_bwd", BWD_ENTRIES)


def table_scratch(b: int, h: int, l: int, num_buckets: int, device) -> torch.Tensor:
    """K2's and K2a's scratch: a slice of ``L + num_buckets + 1`` table sums for each CTA, ``ceil(L / 32)`` CTAs per
    (batch, head) (the width-tiled variants use half of them), which the second kernel adds in CTA order."""
    return torch.empty(b * h * (-(-l // 32)) * (l + num_buckets + 1), dtype=torch.float32, device=device)


def _launch_bwd(entry: str, q, k, v, g, pos_w, ts_w, timestamps, padding_mask, thresholds, alpha: float, max_seq_len: int, cfg: BucketCfg, dq=None, dk=None, dv=None, dpos=None, dts=None) -> None:
    """Launch one backward kernel into the given outputs (None: not produced); K2 and K2a with a scratch buffer for
    their table sums."""
    num_buckets = ts_w.shape[0] - 1
    _check_kernel_inputs(q, k, v, pos_w, ts_w, timestamps, padding_mask, thresholds, max_seq_len, num_buckets)
    b, h, l, dqk = q.shape
    dv_dim = v.shape[-1]
    if g.device != q.device or g.dtype != v.dtype or g.shape != v.shape or not g.is_contiguous():
        raise ValueError(f"{entry}: the output gradient must be a contiguous {v.dtype} {tuple(v.shape)} tensor on {q.device}, got {g.dtype} {tuple(g.shape)} on {g.device}")
    if dpos is not None and num_buckets > MAX_BWD_BUCKETS:
        raise ValueError(f"{entry}: {num_buckets} time buckets: the card's shared memory holds the dts sums of at most {MAX_BWD_BUCKETS} (one table of "
                         f"num_buckets + 1 floats beside the tiles, 232,448 bytes a CTA)")
    scratch = None if dpos is None else table_scratch(b, h, l, num_buckets, q.device)
    if q.dtype == torch.bfloat16:
        lib, entry = _lib_bwd_bf16(), entry + "_bf16"
    else:
        lib = _lib_bwd()

    def ptr(t):
        return None if t is None else t.data_ptr()

    taken = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), pos_w.data_ptr(), ts_w.data_ptr(), thresholds.data_ptr(),
            ptr(timestamps), ptr(padding_mask), ptr(dq), ptr(dk), ptr(dv), ptr(dpos), ptr(dts), ptr(scratch),
            b, h, l, dqk, dv_dim, max_seq_len, num_buckets, float(alpha), *bucket_codes(cfg), stream, ctypes.byref(taken),
        )
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: {lib.hstu_rab_bwd_error_string(rc).decode()} (B={b} H={h} L={l} dqk={dqk} dv={dv_dim})")
    _count_wide(entry, taken)


def occupancy(l: int, dqk: int, dv: int, max_seq_len: int, num_buckets: int) -> dict:
    """K1, K2, K2a and K2b as this shape would launch them: ``{name: (CTAs per SM, registers per thread, shared bytes
    per CTA, variant)}``, the variant :data:`TENSOR_CORE` or :data:`WIDE` (K2's: its first kernel, K2a's).

    From ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` and
    ``cudaFuncGetAttributes`` through the C interface; nothing is launched.
    """
    queries = [("hstu_rab_fwd", _lib().hstu_rab_fwd_occupancy, ())]
    queries += [(name, _lib_bwd().hstu_rab_bwd_occupancy, (which,)) for which, name in enumerate(BWD_ENTRIES)]
    return _query_occupancy(queries, l, dqk, dv, max_seq_len, num_buckets)


def occupancy_bf16(l: int, dqk: int, dv: int, max_seq_len: int, num_buckets: int) -> dict:
    """The bf16 K1, K2, K2a and K2b as :func:`occupancy` reports the fp32 kernels."""
    queries = [("hstu_rab_fwd_bf16", _lib_bf16().hstu_rab_fwd_bf16_occupancy, ())]
    queries += [(name, _lib_bwd_bf16().hstu_rab_bwd_bf16_occupancy, (which,)) for which, name in enumerate(BWD_ENTRIES_BF16)]
    return _query_occupancy(queries, l, dqk, dv, max_seq_len, num_buckets)


def launch_shape_bf16(name: str, l: int, dqk: int, dv: int, max_seq_len: int, num_buckets: int) -> tuple:
    """A bf16 rab kernel (by entry name) as this shape would launch it: ``(CTAs per SM, registers per thread, shared
    bytes per CTA, ring stages, variant)``, the stages 2, or 1 where two do not fit (K1-bf16's and K2a-bf16's K/V
    ring, K2's and K2b's Q/G ring; the width-tiled variant has none: 1), the variant :data:`TENSOR_CORE` or
    :data:`WIDE`.  Nothing is launched."""
    if name == "hstu_rab_fwd_bf16":
        query = (name, _lib_bf16().hstu_rab_fwd_bf16_occupancy, ())
    elif name in BWD_ENTRIES_BF16:
        query = (name, _lib_bwd_bf16().hstu_rab_bwd_bf16_occupancy, (BWD_ENTRIES_BF16.index(name),))
    else:
        raise ValueError(f"launch_shape_bf16: {name} is not a bf16 rab kernel; hstu_rab_fwd_bf16 and {', '.join(BWD_ENTRIES_BF16)} are")
    return _query_occupancy([query], l, dqk, dv, max_seq_len, num_buckets, full=True)[name]


def dts_tables(name: str, l: int, dqk: int, dv: int, max_seq_len: int, num_buckets: int) -> int:
    """How K2 or K2a (by entry name, fp32 or bf16) would sum dts at this shape in shared memory: 32 tables (a copy
    per warp and lane column), 8 (one a warp) or 1 (one table, which the warps add to in turns, as they add to
    dpos); 0 where the width-tiled variant takes the shape (tables of its own).  Nothing is launched."""
    if name in BWD_ENTRIES[:2]:
        query, which = _lib_bwd().hstu_rab_bwd_occupancy, BWD_ENTRIES.index(name)
    elif name in BWD_ENTRIES_BF16[:2]:
        query, which = _lib_bwd_bf16().hstu_rab_bwd_bf16_occupancy, BWD_ENTRIES_BF16.index(name)
    else:
        raise ValueError(f"dts_tables: {name} sums no dts; {', '.join(BWD_ENTRIES[:2] + BWD_ENTRIES_BF16[:2])} do")
    info = (ctypes.c_int * 6)()
    rc = query(which, l, dqk, dv, max_seq_len, num_buckets, info)
    if rc != 0:
        raise RuntimeError(f"{name} occupancy query failed: error {rc}")
    return 0 if info[4] else info[5]


def variant_name(info) -> str:
    """The variant an occupancy query's ``info[4]`` names."""
    return WIDE if info[4] else TENSOR_CORE


def _query_occupancy(queries, l, dqk, dv, max_seq_len, num_buckets, full=False) -> dict:
    out = {}
    for name, query, which in queries:
        info = (ctypes.c_int * 6)()  # the bf16 kernels also give their ring stages in info[3]; info[4] the variant; info[5] dts_tables'
        rc = query(*which, l, dqk, dv, max_seq_len, num_buckets, info)
        if rc != 0:
            raise RuntimeError(f"{name} occupancy query failed: error {rc}")
        out[name] = (*tuple(info)[:4 if full else 3], variant_name(info))
    return out


def _dispatch_bwd(name: str, q, k, v, g, pos_w, ts_w, timestamps, padding_mask, alpha, max_seq_len, cfg, thresholds):
    """CPU: the plain backward (None); CUDA: the thresholds the kernel takes; else raise."""
    if q.device.type == "cpu":
        plain = plain_backward_bf16 if q.dtype == torch.bfloat16 else dense_backward
        return plain(q, k, v, g, pos_w, ts_w, timestamps, padding_mask, alpha, max_seq_len, cfg, timestamps is not None), None
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on the CPU (plain version) or a CUDA device (kernel), not {q.device}")
    return None, compute_bucket_thresholds(cfg).to(q.device) if thresholds is None else thresholds


def rab_backward_fused(q, k, v, g, pos_w, ts_w, timestamps, padding_mask, alpha: float, max_seq_len: int, cfg: BucketCfg, thresholds: Optional[torch.Tensor] = None):
    """K2: ``(dq, dk, dv, dpos, dts)`` in one pass (the plain version on the CPU).

    dq is a sum of fp32 vector reductions across CTAs, whose order changes
    from run to run; dk, dv, dpos and dts are summed in a fixed order, the
    same bit for bit from run to run.  On bf16 inputs (the bf16 variant) dq
    is summed into an f32 buffer and rounded to bf16 after the kernel, as
    the JAX package rounds the Pallas kernel's f32 dq.
    """
    global launches_bwd, launches_bwd_bf16
    plain, thresholds = _dispatch_bwd("rab_backward_fused", q, k, v, g, pos_w, ts_w, timestamps, padding_mask, alpha, max_seq_len, cfg, thresholds)
    if plain is not None:
        return plain
    if q.dtype == torch.bfloat16:
        dq32, dk, dv = torch.zeros(q.shape, dtype=torch.float32, device=q.device), torch.empty_like(k), torch.empty_like(v)
        dpos, dts = torch.zeros_like(pos_w), torch.zeros_like(ts_w)
        _launch_bwd("hstu_rab_bwd", q, k, v, g, pos_w, ts_w, timestamps, padding_mask, thresholds, alpha, max_seq_len, cfg, dq=dq32, dk=dk, dv=dv, dpos=dpos, dts=dts)
        launches_bwd_bf16 += 1
        return dq32.to(torch.bfloat16), dk, dv, dpos, dts
    dq, dk, dv = torch.zeros_like(q), torch.empty_like(k), torch.empty_like(v)
    dpos, dts = torch.zeros_like(pos_w), torch.zeros_like(ts_w)
    _launch_bwd("hstu_rab_bwd", q, k, v, g, pos_w, ts_w, timestamps, padding_mask, thresholds, alpha, max_seq_len, cfg, dq=dq, dk=dk, dv=dv, dpos=dpos, dts=dts)
    launches_bwd += 1
    return dq, dk, dv, dpos, dts


def rab_backward_dq(q, k, v, g, pos_w, ts_w, timestamps, padding_mask, alpha: float, max_seq_len: int, cfg: BucketCfg, thresholds: Optional[torch.Tensor] = None):
    """K2a: ``(dq, dpos, dts)`` (the plain version's on the CPU), dq in q's dtype.

    dq is written once per row, its partials summed in a fixed order (in
    f32 registers, rounded once for bf16), and dpos and dts in a fixed order
    too: all three the same bit for bit from run to run.
    """
    global launches_bwd_dq, launches_bwd_dq_bf16
    plain, thresholds = _dispatch_bwd("rab_backward_dq", q, k, v, g, pos_w, ts_w, timestamps, padding_mask, alpha, max_seq_len, cfg, thresholds)
    if plain is not None:
        return plain[0], plain[3], plain[4]
    dq = torch.empty_like(q)
    dpos, dts = torch.zeros_like(pos_w), torch.zeros_like(ts_w)
    _launch_bwd("hstu_rab_bwd_dq", q, k, v, g, pos_w, ts_w, timestamps, padding_mask, thresholds, alpha, max_seq_len, cfg, dq=dq, dpos=dpos, dts=dts)
    if q.dtype == torch.bfloat16:
        launches_bwd_dq_bf16 += 1
    else:
        launches_bwd_dq += 1
    return dq, dpos, dts


def rab_backward_dkv(q, k, v, g, pos_w, ts_w, timestamps, padding_mask, alpha: float, max_seq_len: int, cfg: BucketCfg, thresholds: Optional[torch.Tensor] = None):
    """K2b: ``(dk, dv)`` in k's and v's dtype (the plain version's on the CPU), the same bit for bit from run to run."""
    global launches_bwd_dkv, launches_bwd_dkv_bf16
    plain, thresholds = _dispatch_bwd("rab_backward_dkv", q, k, v, g, pos_w, ts_w, timestamps, padding_mask, alpha, max_seq_len, cfg, thresholds)
    if plain is not None:
        return plain[1], plain[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("hstu_rab_bwd_dkv", q, k, v, g, pos_w, ts_w, timestamps, padding_mask, thresholds, alpha, max_seq_len, cfg, dk=dk, dv=dv)
    if q.dtype == torch.bfloat16:
        launches_bwd_dkv_bf16 += 1
    else:
        launches_bwd_dkv += 1
    return dk, dv


@torch.library.custom_op("rechub::hstu_rab_fwd", mutates_args=())
def rab_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos_w: torch.Tensor, ts_w: torch.Tensor, timestamps: Optional[torch.Tensor], padding_mask: Optional[torch.Tensor],
                thresholds: Optional[torch.Tensor], alpha: float, max_seq_len: int, num_buckets: int, fn: str, divisor: float, unit: str) -> torch.Tensor:
    """K1 as the registered op ``torch.ops.rechub.hstu_rab_fwd``: ``(B, H, L, dv)`` in q's dtype.

    A CPU tensor takes the plain version (:func:`dense_forward`, or
    :func:`plain_forward_bf16` on bf16), a CUDA tensor launches K1 or its
    bf16 variant (``thresholds`` on the card), any other device raises.
    Being an op, it is what ``torch.export`` records: an exported HSTU
    program holds this call, not the plain version's operations, and runs
    the kernel wherever it is loaded on the card.  Its fake (meta) version
    only makes the output's shape and dtype: tracing builds and launches
    nothing.
    """
    return _forward(q, k, v, pos_w, ts_w, timestamps, padding_mask, thresholds, alpha, max_seq_len, BucketCfg(num_buckets, fn, divisor, unit))


def _forward(q, k, v, pos_w, ts_w, timestamps, padding_mask, thresholds, alpha: float, max_seq_len: int, cfg: BucketCfg) -> torch.Tensor:
    """The op's body, by device: the plain version on the CPU, K1 (or K1-bf16) on a CUDA device, else raise."""
    if q.device.type == "cpu":
        plain = plain_forward_bf16 if q.dtype == torch.bfloat16 else dense_forward
        return plain(q, k, v, pos_w, ts_w, timestamps, padding_mask, alpha, max_seq_len, cfg, timestamps is not None)
    if q.device.type != "cuda":
        raise ValueError(f"hstu_attention_rab runs on the CPU (plain version) or a CUDA device (kernel), not {q.device}")
    return _launch(q, k, v, pos_w, ts_w, timestamps, padding_mask, thresholds, alpha, max_seq_len, cfg)


@rab_forward.register_fake
def _rab_forward_fake(q, k, v, pos_w, ts_w, timestamps, padding_mask, thresholds, alpha, max_seq_len, num_buckets, fn, divisor, unit):
    return q.new_empty((*q.shape[:3], v.shape[-1]))


@register_flop_formula(torch.ops.rechub.hstu_rab_fwd)
def _rab_forward_flops(q_shape, k_shape, v_shape, *args, out_shape=None, **kwargs) -> int:
    """Two products over every (query, key) pair, as PyTorch counts attention: ``2·B·H·L²·(dqk + dv)``."""
    b, h, l, dqk = q_shape
    return 2 * b * h * l * l * (dqk + v_shape[-1])


def _op_forward(q, k, v, pos_w, ts_w, timestamps, padding_mask, thresholds, alpha: float, max_seq_len: int, cfg: BucketCfg) -> torch.Tensor:
    return torch.ops.rechub.hstu_rab_fwd(q, k, v, pos_w, ts_w, timestamps, padding_mask, thresholds, float(alpha), int(max_seq_len), int(cfg.num_buckets), cfg.fn, float(cfg.divisor), cfg.unit)


class _RabAttentionKernel(torch.autograd.Function):
    """K1 forward (through the registered op); K2 backward, or K2a then K2b when ``_FUSED_BWD[0]`` is False or
    ``torch.are_deterministic_algorithms_enabled()``.

    K2's dq is summed by fp32 reductions in an order that changes from run
    to run; the split pair sums every gradient in a fixed order.  So under
    ``torch.use_deterministic_algorithms(True)`` the backward takes the
    split pair and is the same bit for bit from run to run; otherwise the
    fused K2 (one pass, faster).

    Saves the inputs, the tables, the stamps, the mask and the thresholds,
    and no ``(L, L)`` tensor: the backward kernels rebuild every tile.  On
    the CPU (bf16 inputs only) the forward and backward are the plain bf16
    versions.
    """

    @staticmethod
    def forward(ctx, q, k, v, pos_w, ts_w, timestamps, padding_mask, thresholds, alpha, max_seq_len, cfg):
        ctx.save_for_backward(q, k, v, pos_w, ts_w, timestamps, padding_mask, thresholds)
        ctx.alpha, ctx.max_seq_len, ctx.cfg = alpha, max_seq_len, cfg
        return _op_forward(q, k, v, pos_w, ts_w, timestamps, padding_mask, thresholds, alpha, max_seq_len, cfg)

    @staticmethod
    def backward(ctx, grad_out):
        # the gradient arrives through attn_out.transpose(1, 2).reshape(...): not contiguous
        g = grad_out.contiguous()
        q, k, v, pos_w, ts_w, timestamps, padding_mask, thresholds = ctx.saved_tensors
        args = (q, k, v, g, pos_w, ts_w, timestamps, padding_mask, ctx.alpha, ctx.max_seq_len, ctx.cfg, thresholds)
        if _FUSED_BWD[0] and not torch.are_deterministic_algorithms_enabled():
            dq, dk, dv, dpos, dts = rab_backward_fused(*args)
        else:
            dq, dpos, dts = rab_backward_dq(*args)
            dk, dv = rab_backward_dkv(*args)
        return dq, dk, dv, dpos, dts, None, None, None, None, None, None


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

    Returns ``(B, H, L, dv)`` in q's dtype: float32, or bfloat16 for bf16
    q, k, v (the mixed-precision policy; the tables stay float32).
    """
    l = q.shape[2]
    if l > max_seq_len:
        raise ValueError(f"seq_len ({l}) exceeds max_seq_len ({max_seq_len}).")
    has_time = timestamps is not None
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, pos_w, ts_w))
    if q.device.type == "cpu" and q.dtype != torch.bfloat16:
        if needs_grad:  # autograd through the plain version
            return dense_forward(q, k, v, pos_w, ts_w, timestamps, padding_mask, alpha, max_seq_len, cfg, has_time)
        return _op_forward(q, k, v, pos_w, ts_w, timestamps, padding_mask, thresholds, alpha, max_seq_len, cfg)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"hstu_attention_rab runs on the CPU (plain version) or a CUDA device (kernel), not {q.device}")
    if ts_w.shape[0] != cfg.num_buckets + 1:
        raise ValueError(f"hstu_attention_rab: ts_w has {ts_w.shape[0]} rows, cfg {cfg.num_buckets + 1}")
    if thresholds is None and q.device.type == "cuda":
        thresholds = compute_bucket_thresholds(cfg).to(q.device)
    if has_time:
        timestamps = timestamps.to(torch.int32).contiguous()
    if not needs_grad:  # serving, and what torch.export records: the op alone
        return _op_forward(q, k, v, pos_w, ts_w, timestamps, padding_mask, thresholds, alpha, max_seq_len, cfg)
    return _RabAttentionKernel.apply(q, k, v, pos_w, ts_w, timestamps, padding_mask, thresholds, alpha, max_seq_len, cfg)
