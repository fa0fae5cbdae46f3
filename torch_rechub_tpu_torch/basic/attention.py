"""flax's ``LayerNorm`` and ``MultiHeadDotProductAttention``, which BST and SASRec share (HLLM and TIGER the ``LayerNorm``).

Counterparts of ``flax.linen.LayerNorm`` and
``flax.linen.MultiHeadDotProductAttention`` as the JAX package's models use
them (``models/ranking/bst.py``, ``models/matching/sasrec.py``), not
``nn.LayerNorm`` / ``nn.MultiheadAttention``:

- ``LayerNorm`` normalises by ``E[x²] − E[x]²`` (flax's fast variance),
  clamped at 0;
- the attention puts ``1/sqrt(head_dim)`` on the query, masks keys with
  ``finfo(float32).min`` and draws one attention-dropout mask for every row
  and head.

The query may differ from the keys and values: SASRec attends from
``LayerNorm(h)`` to the un-normed ``h``.  Both are flax layers with
``dtype=None``: under the bf16 policy they promote a bf16 input against
their f32 parameters and compute in f32, with f32 outputs.  The parameters keep flax's names:
``query``, ``key``, ``value`` and ``out`` are ``nn.Linear``s over the
flattened heads, which ``utils/jax_weights.py`` fills from flax's
``DenseGeneral`` kernels.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .initializers import linear
from .precision import promote


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: ``(x − E[x]) · rsqrt(max(E[x²] − E[x]², 0) + eps) · scale + bias``.

    ``use_bias=False`` (TIGER's, flax ``LayerNorm(use_bias=False)``) has no
    ``bias`` parameter."""

    def __init__(self, d: int, eps: float = 1e-5, use_bias: bool = True, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = promote(x, self.weight.dtype)
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp_min((x * x).mean(-1, keepdim=True) - mean * mean, 0.0)
        y = (x - mean) * (torch.rsqrt(var + self.eps) * self.weight)
        return y if self.bias is None else y + self.bias


class MultiHeadDotProductAttention(nn.Module):
    """flax's attention from ``inputs_q (B, Lq, d)`` to ``inputs_kv (B, Lk, d)`` (``inputs_q`` itself when
    not given) under a boolean ``mask`` broadcast to ``(B, H, Lq, Lk)`` (True attends)."""

    def __init__(self, d: int, num_heads: int, dropout_rate: float = 0.0, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.num_heads, self.dropout_rate = num_heads, dropout_rate
        for name in ("query", "key", "value", "out"):
            self.add_module(name, linear(d, d, generator, device, policy=False))

    def forward(self, inputs_q: torch.Tensor, mask: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None, inputs_kv: Optional[torch.Tensor] = None) -> torch.Tensor:
        inputs_kv = inputs_q if inputs_kv is None else inputs_kv
        inputs_q, inputs_kv = promote(inputs_q, self.query.weight.dtype), promote(inputs_kv, self.query.weight.dtype)
        b, lq, d = inputs_q.shape
        head_dim = d // self.num_heads
        q = self.query(inputs_q).reshape(b, lq, self.num_heads, head_dim)
        k, v = (m(inputs_kv).reshape(b, inputs_kv.shape[1], self.num_heads, head_dim) for m in (self.key, self.value))
        weights = torch.einsum("bqhd,bkhd->bhqk", q / math.sqrt(head_dim), k)
        if mask is not None:
            weights = weights.masked_fill(~mask, torch.finfo(weights.dtype).min)
        weights = torch.softmax(weights, dim=-1)
        if self.training and self.dropout_rate > 0.0:  # one (Lq, Lk) mask for every row and head
            keep = torch.rand(weights.shape[-2:], generator=generator, device=inputs_q.device) >= self.dropout_rate
            weights = weights * keep.to(weights.dtype) / (1.0 - self.dropout_rate)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, lq, d))
