"""Mixed-precision policy: bf16 compute, f32 parameters and accumulators.

Counterpart of ``torch_rechub_tpu/basic/precision.py``.  Under ``"bf16"``:

- **parameters stay float32**: optimizer moments, LayerNorm / BatchNorm
  scales and statistics, embedding tables;
- **compute casts to bfloat16** at layer boundaries, with flax's ``dtype=``
  rounding: a :class:`Dense` casts its input, weight and bias to bf16, the
  product accumulates in f32 and rounds to bf16, and the bias is added to
  that rounded product (one more rounding), not inside it as ``F.linear``
  / ``addmm`` would;
- **precision-sensitive reductions stay float32**: losses, log-sum-exp
  accumulators, LayerNorm and BatchNorm statistics, the attention kernels'
  accumulators.

Elsewhere the port follows jnp's promotion: a bf16 tensor with an f32 one
gives f32.  The policy is read when a layer runs its forward; the trainers
wrap every forward in :func:`precision_scope` with their ``precision=``
argument, so nothing leaks between trainers of one process.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F

_COMPUTE = ["float32"]  # the active policy, read at forward time

_ALIASES = {
    "bf16": "bfloat16",
    "bfloat16": "bfloat16",
    "mixed": "bfloat16",
    "f32": "float32",
    "fp32": "float32",
    "float32": "float32",
}


def _resolve(name) -> str:
    if name is None:
        return _COMPUTE[0]
    key = str(name).lower()
    if key not in _ALIASES:
        raise ValueError(f"precision must be one of {sorted(set(_ALIASES))}, got {name!r}")
    return _ALIASES[key]


def set_precision(name) -> str:
    """Set the process-wide compute precision; returns the previous value.

    Prefer :func:`precision_scope` (or a trainer's ``precision=``).
    """
    old = _COMPUTE[0]
    _COMPUTE[0] = _resolve(name)
    return old


def precision() -> str:
    """The active compute precision: ``"float32"`` or ``"bfloat16"``."""
    return _COMPUTE[0]


def compute_dtype() -> torch.dtype:
    """The active compute dtype: ``torch.bfloat16`` or ``torch.float32``."""
    return torch.bfloat16 if _COMPUTE[0] == "bfloat16" else torch.float32


def cast_compute(x):
    """Cast a float tensor to the compute dtype (integer and bool tensors pass through)."""
    if x is None:
        return None
    if x.is_floating_point() and x.dtype != compute_dtype():
        return x.to(compute_dtype())
    return x


@contextlib.contextmanager
def precision_scope(name):
    """Context manager form of :func:`set_precision`; ``None`` is a no-op."""
    if name is None:
        yield
        return
    old = set_precision(name)
    try:
        yield
    finally:
        _COMPUTE[0] = old


def dense(x: torch.Tensor, weight: torch.Tensor, bias=None) -> torch.Tensor:
    """flax ``nn.Dense(dtype=compute_dtype())`` on a ``(out, in)`` weight.

    float32: ``F.linear``.  bfloat16: ``round(x W^T) + b`` in bf16, the bias
    added after the product's rounding, as flax adds it.
    """
    dt = compute_dtype()
    if dt == torch.float32:
        return F.linear(x.to(dt), weight, bias)
    y = x.to(dt) @ weight.to(dt).T
    return y if bias is None else y + bias.to(dt)


class _Bf16Sigmoid(torch.autograd.Function):
    """``lax.logistic`` on bf16 as XLA expands it: ``1 / (1 + exp(-x))``, each
    step rounded to bf16; its gradient ``g * (y * (1 - y))``, each step rounded."""

    @staticmethod
    def forward(ctx, x):
        y = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1 - y))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: ``torch.sigmoid`` in f32; XLA's rounding steps in bf16."""
    return torch.sigmoid(x) if x.dtype == torch.float32 else _Bf16Sigmoid.apply(x)


def softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jax.nn.softmax``: ``torch.softmax`` in f32; in bf16 jax's steps, ``e = exp(x - max)``
    and ``e / sum(e)``, each rounded to bf16 (the sum taken in f32), differentiated as they are."""
    if x.dtype == torch.float32:
        return torch.softmax(x, dim=dim)
    e = torch.exp(x - x.amax(dim, keepdim=True).detach())
    return e / e.sum(dim, keepdim=True)


def einsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum``'s promotion: the operands taken in their common dtype (bf16 with f32: f32)."""
    dt = functools.reduce(torch.promote_types, (o.dtype for o in operands))
    return torch.einsum(equation, *(o.to(dt) for o in operands))


def weak(x: torch.Tensor, c: float) -> float:
    """The Python scalar ``c`` as jnp applies it to ``x``: rounded to ``x``'s dtype first (a weak type),
    where PyTorch would apply it in f32 to a bf16 tensor."""
    return float(torch.tensor(c, dtype=x.dtype)) if x.is_floating_point() else c


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``, ``x * sigmoid(x)``: ``F.silu`` in f32; in bf16 the sigmoid and the product each rounded."""
    return F.silu(x) if x.dtype == torch.float32 else x * sigmoid(x)


def promote(x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x`` promoted as jnp promotes it against an operand of ``dtype`` (bf16 with f32: f32)."""
    return x.to(torch.promote_types(x.dtype, dtype)) if x.is_floating_point() else x


class Dense(torch.nn.Linear):
    """``nn.Linear`` whose forward is :func:`dense`: flax ``Dense`` under the active policy."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias)
