"""HSTU silu attention with a materialised bias.

Counterpart of ``torch_rechub_tpu/ops/pallas/hstu_attention.py``: the same
causal silu attention as :mod:`.hstu_rab_attention`, but the relative bias
arrives as a dense tensor, ``(B, H, L, L)`` per batch or ``(1, H, L, L)``
shared across the batch (e.g. the output of
``RelativeBucketedTimeAndPositionBias``).

Kernel, CUDA C++ for Hopper (sm_90a), bound through ctypes: the forward,
``csrc/hstu_attn_fwd.cu``, replaces the TPU's ``_fwd_kernel`` (K3).  It is
K1's design with a bias tile in place of the tables: products in 3xTF32 on
the tensor cores, and the bias tiles at or below the diagonal brought in
with K and V through a ``cp.async`` ring (the source note has the design).
At the serving shape with a per-batch bias it is bound by bytes.

The backward is autograd of :func:`dense_forward` on the saved inputs: the
same recompute as the JAX package's XLA backward (``_hstu_bwd``), which has
no kernel there either.

Dispatch: a tensor on the CPU takes :func:`dense_forward` (differentiable
by autograd).  A tensor on a CUDA device launches the kernel, or raises:
there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

# kernel launches of this process; reset and read by chip_smoke.py
launches = 0  # K3, hstu_attn_fwd

MAX_DV = 128
MAX_DQK = 256


# ---------------------------------------------------------------------------
# plain PyTorch version (CPU path, the backward, and the kernel's yardstick on the card)
# ---------------------------------------------------------------------------

def dense_forward(q, k, v, bias, padding_mask, alpha: float, max_seq_len: float) -> torch.Tensor:
    """``(B, H, L, dv)``; a ``(1, H, L, L)`` bias broadcasts over the batch."""
    l = q.shape[2]
    scores = torch.einsum("bhld,bhmd->bhlm", q, k) * alpha + bias
    valid = torch.tril(torch.ones((l, l), dtype=torch.bool, device=q.device))[None, None]
    if padding_mask is not None:
        valid = valid & padding_mask[:, None, None, :]
    scores = scores.masked_fill(~valid, -1e4)  # replaces: a NaN bias at a masked pair does not reach the output
    attn = F.silu(scores) / max_seq_len
    return torch.einsum("bhlm,bhmd->bhld", attn, v)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    lib = _build.load("hstu_attn_fwd")
    if lib.hstu_attn_fwd.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.hstu_attn_fwd.argtypes = [p] * 6 + [i] * 6 + [f, f, p]
        lib.hstu_attn_fwd.restype = i
        lib.hstu_attn_fwd_occupancy.argtypes = [i] * 3 + [p]
        lib.hstu_attn_fwd_occupancy.restype = i
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
    for name in ("q", "k", "v", "bias"):
        if named[name].dtype != torch.float32:
            raise TypeError(f"hstu_attention: the CUDA kernel takes float32, got {name} {named[name].dtype}")
    if k.shape != q.shape or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"hstu_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if bias.ndim != 4 or bias.shape[0] not in (1, b) or tuple(bias.shape[1:]) != (h, l, l):
        raise ValueError(f"hstu_attention: bias must be (1 or {b}, {h}, {l}, {l}), got {tuple(bias.shape)}")
    if padding_mask is not None and (padding_mask.dtype != torch.bool or tuple(padding_mask.shape) != (b, l)):
        raise ValueError("hstu_attention: padding_mask must be bool (B, L)")
    if not (1 <= dv <= MAX_DV and 1 <= dqk <= MAX_DQK):
        raise ValueError(f"hstu_attention: the CUDA kernel takes dv <= {MAX_DV} and dqk <= {MAX_DQK}, got dqk={dqk} dv={dv}")
    if -(-l // 32) > 65535:
        raise ValueError(f"hstu_attention: L = {l} exceeds the grid limit of 65535 tiles of 32 rows")


def _launch(q, k, v, bias, padding_mask, alpha: float, max_seq_len: float) -> torch.Tensor:
    global launches
    _check_kernel_inputs(q, k, v, bias, padding_mask)
    b, h, l, dqk = q.shape
    dv = v.shape[-1]
    out = torch.empty((b, h, l, dv), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.hstu_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), None if padding_mask is None else padding_mask.data_ptr(),
            out.data_ptr(), b, h, l, dqk, dv, int(bias.shape[0] == 1), float(alpha), float(max_seq_len), stream,
        )
    if rc != 0:
        raise RuntimeError(f"hstu_attn_fwd launch failed: {lib.hstu_attn_error_string(rc).decode()} (B={b} H={h} L={l} dqk={dqk} dv={dv})")
    launches += 1
    return out


def occupancy(l: int, dqk: int, dv: int) -> tuple:
    """K3 as this shape would launch it: ``(CTAs per SM, registers per thread, shared bytes per CTA)``.

    From ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` and
    ``cudaFuncGetAttributes`` through the C interface; nothing is launched.
    """
    info = (ctypes.c_int * 3)()
    rc = _lib().hstu_attn_fwd_occupancy(l, dqk, dv, info)
    if rc != 0:
        raise RuntimeError(f"hstu_attn_fwd occupancy query failed: error {rc}")
    return tuple(info)


class _AttentionKernel(torch.autograd.Function):
    """K3 forward; backward by autograd of :func:`dense_forward` on the saved inputs.

    The JAX package's backward of this op is an XLA recompute with no
    kernel, so this is its counterpart, not a fallback.  dbias keeps the
    bias's shape: a shared bias gets its gradient summed over the batch.
    """

    @staticmethod
    def forward(ctx, q, k, v, bias, padding_mask, alpha, max_seq_len):
        ctx.save_for_backward(q, k, v, bias, padding_mask)
        ctx.alpha, ctx.max_seq_len = alpha, max_seq_len
        return _launch(q, k, v, bias, padding_mask, alpha, max_seq_len)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, bias, padding_mask = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v, bias)]
            out = dense_forward(*leaves, padding_mask, ctx.alpha, ctx.max_seq_len)
            dq, dk, dv, dbias = torch.autograd.grad(out, leaves, grad_out)
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

    Returns ``(B, H, L, dv)``.
    """
    if q.device.type == "cpu":
        return dense_forward(q, k, v, bias, padding_mask, alpha, max_seq_len)
    if q.device.type != "cuda":
        raise ValueError(f"hstu_attention runs on the CPU (plain version) or a CUDA device (kernel), not {q.device}")
    return _AttentionKernel.apply(q, k, v, bias, padding_mask, alpha, max_seq_len)
