"""HSTU sequential-transduction layers (Eq. 2-4 of "Actions Speak Louder
than Words", arXiv:2402.17152).

Counterpart of ``torch_rechub_tpu/basic/hstu.py``:

- Eq.2: one SiLU on the joint UVQK projection before the split (columns
  q | k | u | v).
- Eq.3: ``silu(Q K^T * alpha + rab^{p,t}) / max_seq_len`` attention, no
  softmax normaliser, causal + key-padding masking at -1e4.
- Eq.4: ``proj2(LayerNorm(A V) * U)``; the residual is added in ``HSTUBlock``.

``use_fused_kernel=True`` sends the attention through ``hstu_attention_rab``
(the CUDA kernels on the card, forward and backward; the plain version on
the CPU); ``False`` materialises the dense bias with
``RelativeBucketedTimeAndPositionBias``.

Dropout draws its masks from the ``generator`` passed to ``forward`` (the
trainer's), not from torch's global RNG; it is active in ``train()`` mode.

Under the bf16 policy (``basic/precision.py``) the LayerNorms run in f32,
``proj1`` / ``proj2`` and the attention in bf16, and the residual stream is
bf16, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.cuda.hstu_rab_attention import BucketCfg, compute_bucket_thresholds, hstu_attention_rab
from ..utils.hstu_utils import RelativeBucketedTimeAndPositionBias
from .initializers import linear
from .precision import einsum, silu, weak


def dropout(x: torch.Tensor, p: float, training: bool, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout with masks from ``generator`` (flax ``nn.Dropout``: keep with
    probability ``1-p``, scale kept values by ``1/(1-p)``)."""
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class HSTULayer(nn.Module):
    def __init__(self, d_model: int = 512, n_heads: int = 8, dqk: int = 64, dv: int = 64, dropout: float = 0.1, max_seq_len: int = 200, num_time_buckets: int = 128, time_bucket_fn: str = "sqrt", time_bucket_divisor: float = 1.0, time_bucket_unit: str = "minutes", use_fused_kernel: bool = True, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if d_model % n_heads != 0:
            raise ValueError(f"d_model ({d_model}) must be divisible by n_heads ({n_heads}).")
        self.n_heads, self.dqk, self.dv = n_heads, dqk, dv
        self.max_seq_len = max_seq_len
        self.use_fused_kernel = use_fused_kernel
        self.cfg = BucketCfg(num_buckets=num_time_buckets, fn=time_bucket_fn, divisor=time_bucket_divisor, unit=time_bucket_unit)
        self.norm_in = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.proj1 = linear(d_model, 2 * n_heads * dqk + 2 * n_heads * dv, generator, device)
        self.rab = RelativeBucketedTimeAndPositionBias(n_heads, max_seq_len, num_time_buckets, time_bucket_fn, time_bucket_divisor, time_bucket_unit, generator=generator, device=device)
        self.norm_attn = nn.LayerNorm(n_heads * dv, eps=1e-5, device=device)
        self.dropout = dropout
        self.proj2 = linear(n_heads * dv, d_model, generator, device)
        # the kernel's integer bucket edges, computed once and moved with the module
        self.register_buffer("bucket_thresholds", torch.as_tensor(compute_bucket_thresholds(self.cfg), device=device), persistent=False)

    def forward(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None, time_diffs: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, l, _ = x.shape
        h, dqk, dv = self.n_heads, self.dqk, self.dv
        alpha = 1.0 / math.sqrt(dqk)

        proj = silu(self.proj1(self.norm_in(x.to(torch.float32))))
        q, k, u, v = torch.split(proj, [h * dqk, h * dqk, h * dv, h * dv], dim=-1)
        q = q.reshape(b, l, h, dqk)
        k = k.reshape(b, l, h, dqk)
        v = v.reshape(b, l, h, dv)

        if self.use_fused_kernel:
            # only the small tables reach the kernel: no (B, H, L, L) bias
            pos_w, ts_w = self.rab.tables()
            attn_out = hstu_attention_rab(
                q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous(),
                pos_w, ts_w, time_diffs, padding_mask, alpha, self.max_seq_len, self.cfg, self.bucket_thresholds,
            )  # (B, H, L, dv)
            out = attn_out.transpose(1, 2).reshape(b, l, h * dv)
        else:
            bias = self.rab(time_diffs=time_diffs, seq_len=l)
            scores = torch.einsum("blhd,bmhd->bhlm", q, k)
            scores = scores * weak(scores, alpha) + bias
            valid = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))[None, None]
            if padding_mask is not None:
                valid = valid & padding_mask[:, None, None, :]
            scores = scores.masked_fill(~valid, -1e4)
            attn = nn.functional.silu(scores) / self.max_seq_len
            out = einsum("bhlm,bmhd->blhd", attn, v).reshape(b, l, h * dv)
        gated = dropout(self.norm_attn(out.to(torch.float32)) * u, self.dropout, self.training, generator)
        return self.proj2(gated)


class HSTUBlock(nn.Module):
    """``n_layers`` residual ``HSTULayer``s: ``x = x + layer(x)``."""

    def __init__(self, d_model: int = 512, n_heads: int = 8, n_layers: int = 4, dqk: int = 64, dv: int = 64, dropout: float = 0.1, max_seq_len: int = 200, num_time_buckets: int = 128, time_bucket_fn: str = "sqrt", time_bucket_divisor: float = 1.0, time_bucket_unit: str = "minutes", use_fused_kernel: bool = True, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            HSTULayer(d_model, n_heads, dqk, dv, dropout, max_seq_len, num_time_buckets, time_bucket_fn, time_bucket_divisor, time_bucket_unit, use_fused_kernel, generator=generator, device=device)
            for _ in range(n_layers)
        )

    def forward(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None, time_diffs: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for layer in self.layers:
            x = x + layer(x, padding_mask=padding_mask, time_diffs=time_diffs, generator=generator)
        return x
