"""HSTU silu attention with a materialised bias.

Counterpart of ``torch_rechub_tpu/ops/pallas/hstu_attention.py``: the same
causal silu attention as :mod:`.hstu_rab_attention`, but the relative bias
arrives as a dense tensor, ``(B, H, L, L)`` per batch or ``(1, H, L, L)``
shared across the batch (e.g. the output of
``RelativeBucketedTimeAndPositionBias``).

Kernels, CUDA C++ for Hopper (sm_90a), bound through ctypes, replace the
TPU's ``_fwd_kernel`` (K3):

- fp32, ``csrc/hstu_attn_fwd.cu``: K1's design with a bias tile in place of
  the tables: products in 3xTF32 on the tensor cores, and the bias tiles at
  or below the diagonal brought in with K and V through a ``cp.async`` ring
  (the source note has the design).  At the serving shape with a per-batch
  bias it is bound by bytes.
- bf16 (the mixed-precision policy, ``basic/precision.py``),
  ``csrc/hstu_attn_fwd_bf16.cu``: bf16 q, k, v with an f32 or bf16 bias, per
  batch or shared; the fp32 kernel's Hopper design in bf16, with
  ``mma.sync.m16n8k16`` bf16 and f32 accumulators and the bias tile (either
  dtype) in the ``cp.async`` ring.  It rounds where the Pallas kernel
  rounds: the scores in f32 (the bias promoted), ``attn = silu(s) / N``
  kept in f32 for ``attn @ v`` (as three bf16 terms hi + mid + lo), only
  the output rounded to bf16 (:func:`plain_forward_bf16` is its plain
  version).
- any width: where the tensor-core kernel does not take the shape (dv > 128
  or dqk > 256) the same entry launches its width-tiled variant
  (``csrc/hstu_wide.cuh``, the materialised bias read by element), in
  either dtype; ``launches_wide`` counts those launches.

The backward is autograd of :func:`dense_forward` on the saved inputs: the
same recompute as the JAX package's XLA backward (``_hstu_bwd``), which has
no kernel there either, in either dtype.

Dispatch: a tensor on the CPU takes the plain versions (fp32:
:func:`dense_forward`, differentiable by autograd; bf16 q: the forward
:func:`plain_forward_bf16`, at the Pallas kernel's rounding points, and the
same autograd backward).  A tensor on a CUDA device launches the kernel, or
raises: there is no fallback and no cast between the two precisions.
"""

from __future__ import annotations

import ctypes

import torch

from ...basic.precision import einsum, promote, silu, weak
from . import _build
from .hstu_rab_attention import variant_name

# kernel launches of this process; reset and read by chip_smoke.py
launches = 0  # K3, hstu_attn_fwd
launches_bf16 = 0  # K3 in bf16, hstu_attn_fwd_bf16
launches_wide = {}  # entry name -> launches that took the width-tiled variant (each also counts on the entry's own count)


# ---------------------------------------------------------------------------
# plain PyTorch version (CPU path, the backward, and the kernel's yardstick on the card)
# ---------------------------------------------------------------------------

def dense_forward(q, k, v, bias, padding_mask, alpha: float, max_seq_len: float) -> torch.Tensor:
    """``(B, H, L, dv)``; a ``(1, H, L, L)`` bias broadcasts over the batch.

    The JAX op's ``_xla_reference`` in either dtype: on bf16 inputs ``q @ k``
    is rounded, the scalars round to it as jnp's weak types do, silu takes
    XLA's rounding steps, and an f32 bias promotes the rest to f32.
    """
    l = q.shape[2]
    qk = torch.einsum("bhld,bhmd->bhlm", q, k)
    scores = promote(qk * weak(qk, alpha), bias.dtype) + bias
    valid = torch.tril(torch.ones((l, l), dtype=torch.bool, device=q.device))[None, None]
    if padding_mask is not None:
        valid = valid & padding_mask[:, None, None, :]
    scores = scores.masked_fill(~valid, -1e4)  # replaces: a NaN bias at a masked pair does not reach the output
    attn = silu(scores) / weak(scores, max_seq_len)
    return einsum("bhlm,bhmd->bhld", attn, v)  # bf16 v with an f32 bias: f32, as jnp promotes


def plain_forward_bf16(q, k, v, bias, padding_mask, alpha: float, max_seq_len: float) -> torch.Tensor:
    """K3 on bf16 q, k, v as the Pallas kernel rounds: ``(B, H, L, dv)`` bf16.

    f32 scores of the bf16 ``q @ k`` (exact products, f32 sums) plus the
    bias (f32 or bf16, promoted), -1e4 at masked pairs; ``attn = silu(s) / N``
    kept in f32 for ``attn @ v`` (unlike K1's kernel, which rounds it); only
    the output rounded to bf16.  (The JAX op's dense fallback rounds
    ``q @ k`` and ``attn`` instead.)
    """
    l = q.shape[2]
    s = torch.einsum("bhld,bhmd->bhlm", q.float(), k.float()) * alpha + bias.float()
    valid = torch.tril(torch.ones((l, l), dtype=torch.bool, device=q.device))[None, None]
    if padding_mask is not None:
        valid = valid & padding_mask[:, None, None, :]
    s = s.masked_fill(~valid, -1e4)
    attn = s * torch.sigmoid(s) * (1.0 / max_seq_len)
    return torch.einsum("bhlm,bhmd->bhld", attn, v.float()).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    lib = _build.load("hstu_attn_fwd")
    if lib.hstu_attn_fwd.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.hstu_attn_fwd.argtypes = [p] * 6 + [i] * 6 + [f, f, p, p]  # ..., stream, taken
        lib.hstu_attn_fwd.restype = i
        lib.hstu_attn_fwd_occupancy.argtypes = [i] * 3 + [p]
        lib.hstu_attn_fwd_occupancy.restype = i
        lib.hstu_attn_error_string.argtypes = [i]
        lib.hstu_attn_error_string.restype = ctypes.c_char_p
    return lib


def _lib_bf16() -> ctypes.CDLL:
    lib = _build.load("hstu_attn_fwd_bf16")
    if lib.hstu_attn_fwd_bf16.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.hstu_attn_fwd_bf16.argtypes = [p] * 6 + [i] * 7 + [f, f, p, p]  # shared_bias, then bias_bf16; ..., stream, taken
        lib.hstu_attn_fwd_bf16.restype = i
        lib.hstu_attn_fwd_bf16_occupancy.argtypes = [i] * 4 + [p]
        lib.hstu_attn_fwd_bf16_occupancy.restype = i
        lib.hstu_attn_error_string.argtypes = [i]
        lib.hstu_attn_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_inputs(q, k, v, bias, padding_mask):
    b, h, l, dqk = q.shape
    dv = v.shape[-1]
    named = {"q": q, "k": k, "v": v, "bias": bias, "padding_mask": padding_mask}
    for name, t in named.items():
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"hstu_attention: {name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"hstu_attention: {name} must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"hstu_attention: the CUDA kernels take q, k, v all float32 or all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    bias_dtypes = (torch.float32, torch.bfloat16) if q.dtype == torch.bfloat16 else (torch.float32,)
    if bias.dtype not in bias_dtypes:
        raise TypeError(f"hstu_attention: the {q.dtype} kernel takes a bias of {' or '.join(map(str, bias_dtypes))}, got {bias.dtype}")
    if k.shape != q.shape or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"hstu_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if bias.ndim != 4 or bias.shape[0] not in (1, b) or tuple(bias.shape[1:]) != (h, l, l):
        raise ValueError(f"hstu_attention: bias must be (1 or {b}, {h}, {l}, {l}), got {tuple(bias.shape)}")
    if padding_mask is not None and (padding_mask.dtype != torch.bool or tuple(padding_mask.shape) != (b, l)):
        raise ValueError("hstu_attention: padding_mask must be bool (B, L)")
    if -(-l // 64) > 65535:
        raise ValueError(f"hstu_attention: L = {l} exceeds the card's grid limit of 65535 tiles of 64 rows")


def _launch(q, k, v, bias, padding_mask, alpha: float, max_seq_len: float) -> torch.Tensor:
    """K3, or its bf16 variant when q is bf16: the output in q's dtype."""
    global launches, launches_bf16
    _check_kernel_inputs(q, k, v, bias, padding_mask)
    b, h, l, dqk = q.shape
    dv = v.shape[-1]
    bf16 = q.dtype == torch.bfloat16
    name = "hstu_attn_fwd_bf16" if bf16 else "hstu_attn_fwd"
    out = torch.empty((b, h, l, dv), dtype=q.dtype, device=q.device)
    lib = _lib_bf16() if bf16 else _lib()
    layout = (int(bias.shape[0] == 1), int(bias.dtype == torch.bfloat16)) if bf16 else (int(bias.shape[0] == 1),)
    taken = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), None if padding_mask is None else padding_mask.data_ptr(),
            out.data_ptr(), b, h, l, dqk, dv, *layout, float(alpha), float(max_seq_len), stream, ctypes.byref(taken),
        )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {lib.hstu_attn_error_string(rc).decode()} (B={b} H={h} L={l} dqk={dqk} dv={dv})")
    if taken.value:
        launches_wide[name] = launches_wide.get(name, 0) + 1
    if bf16:
        launches_bf16 += 1
    else:
        launches += 1
    return out


def occupancy(l: int, dqk: int, dv: int) -> tuple:
    """K3 as this shape would launch it: ``(CTAs per SM, registers per thread, shared bytes per CTA, variant)``, the
    variant ``"tensor-core"`` or ``"width-tiled"``.

    From ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` and
    ``cudaFuncGetAttributes`` through the C interface; nothing is launched.
    """
    info = (ctypes.c_int * 5)()
    rc = _lib().hstu_attn_fwd_occupancy(l, dqk, dv, info)
    if rc != 0:
        raise RuntimeError(f"hstu_attn_fwd occupancy query failed: error {rc}")
    return (*tuple(info)[:3], variant_name(info))


def occupancy_bf16(l: int, dqk: int, dv: int, bias_bf16: bool = False) -> tuple:
    """K3-bf16 (with a bf16 or an f32 bias) as :func:`occupancy` reports K3, and its ring stages: ``(CTAs per SM,
    registers per thread, shared bytes per CTA, ring stages, variant)``, the stages 2 (1 for the width-tiled
    variant)."""
    info = (ctypes.c_int * 5)()
    rc = _lib_bf16().hstu_attn_fwd_bf16_occupancy(l, dqk, dv, int(bias_bf16), info)
    if rc != 0:
        raise RuntimeError(f"hstu_attn_fwd_bf16 occupancy query failed: error {rc}")
    return (*tuple(info)[:4], variant_name(info))


class _AttentionKernel(torch.autograd.Function):
    """K3 forward; backward by autograd of :func:`dense_forward` on the saved inputs.

    The JAX package's backward of this op is an XLA recompute with no
    kernel, so this is its counterpart, not a fallback.  dbias keeps the
    bias's shape: a shared bias gets its gradient summed over the batch.
    On the CPU (bf16 q only) the forward is :func:`plain_forward_bf16`.
    """

    @staticmethod
    def forward(ctx, q, k, v, bias, padding_mask, alpha, max_seq_len):
        ctx.save_for_backward(q, k, v, bias, padding_mask)
        ctx.alpha, ctx.max_seq_len = alpha, max_seq_len
        if q.device.type == "cpu" and q.dtype == torch.bfloat16:
            return plain_forward_bf16(q, k, v, bias, padding_mask, alpha, max_seq_len)
        return _launch(q, k, v, bias, padding_mask, alpha, max_seq_len)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, bias, padding_mask = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v, bias)]
            out = dense_forward(*leaves, padding_mask, ctx.alpha, ctx.max_seq_len)
            # bf16 q, k, v with an f32 bias: the plain version's output is f32 (jnp's promotion), the op's bf16
            dq, dk, dv, dbias = torch.autograd.grad(out, leaves, grad_out.to(out.dtype))
        return dq, dk, dv, dbias, None, None, None


def hstu_attention(q, k, v, bias, padding_mask, alpha: float, max_seq_len: float) -> torch.Tensor:
    """Fused HSTU attention with a materialised bias.

    Args:
        q, k: ``(B, H, L, dqk)``; v: ``(B, H, L, dv)``.
        bias: ``(B|1, H, L, L)`` rab term; a batch of 1 is shared.
        padding_mask: ``(B, L)`` bool, True = valid key; None = all valid.
        alpha: score scale; max_seq_len: the silu normaliser N (no limit
            on L is implied).

    The JAX op's ``block_q`` / ``block_k`` are TPU tile sizes with no
    counterpart here: the kernel picks its own tiles and takes any L.

    Returns ``(B, H, L, dv)``: float32, or bfloat16 for bf16 q, k, v (the
    mixed-precision policy; the bias may stay float32).
    """
    if q.device.type == "cpu" and q.dtype != torch.bfloat16:
        return dense_forward(q, k, v, bias, padding_mask, alpha, max_seq_len)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"hstu_attention runs on the CPU (plain version) or a CUDA device (kernel), not {q.device}")
    return _AttentionKernel.apply(q, k, v, bias, padding_mask, alpha, max_seq_len)
