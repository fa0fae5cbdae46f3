"""DeepSeek-V2's latent attention (MLA) with YaRN rotary positions, and RMSNorm.

Follows ``DeepseekV2Attention``, ``DeepseekV2YarnRotaryEmbedding`` and
``DeepseekV2RMSNorm`` of the model's ``modeling_deepseek.py`` (the
configuration of https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite), with
no query LoRA (``q_lora_rank`` null) and no biases (``attention_bias`` false).
For ``x (B, L, d)``, ``H`` heads, ``n = qk_nope_head_dim``,
``r = qk_rope_head_dim``, ``dv = v_head_dim``, ``c = kv_lora_rank``:

- RMSNorm: ``w · x · rsqrt(mean(x²) + eps)``, in float32;
- ``q = q_proj(x)`` as ``(B, H, L, n + r)``, split ``q_nope | q_pe``;
- ``kv_a_proj_with_mqa(x)`` split ``ckv (c) | k_pe (r)``, ``k_pe`` one head
  that every head shares;
- ``kv_b_proj(RMSNorm(ckv))`` as ``(B, H, L, n + dv)``, split ``k_nope | v``;
- rotary: ``q_pe`` and ``k_pe`` have their dims permuted from interleaved
  pairs to halves (``view(.., r/2, 2).transpose``), then
  ``x·cos + rotate_half(x)·sin`` at positions ``0 .. L-1``;
- YaRN frequencies: ``f_extra = θ^(-2i/r)``, ``f_inter = f_extra / factor``,
  blended by ``mask = 1 − ramp(i; low, high)`` as
  ``f_inter·(1 − mask) + f_extra·mask``, where ``low, high`` are the
  correction dims of ``beta_fast`` and ``beta_slow`` rotations over
  ``original_max_position_embeddings``; ``cos`` and ``sin`` are scaled by
  ``mscale(factor, mscale) / mscale(factor, mscale_all_dim)`` with
  ``mscale(s, m) = 0.1·m·ln(s) + 1`` (1 for ``s <= 1``);
- ``softmax((q_nope|q_pe)·(k_nope|k_pe)ᵀ · scale + mask) · v`` with
  ``scale = (n + r)^-0.5 · mscale(factor, mscale_all_dim)²``;
- ``o_proj`` of the heads' outputs, ``(B, L, H·dv) → (B, L, d)``.

The mask is causal and hides padding keys.  A padding query (a position
before a left-padded history starts) sees no key: its scores are filled with
``finfo(float32).min`` rather than ``-inf`` so that the softmax stays finite,
and its output is zero, never NaN.

Spans (``utils/profiling.py``): ``rechub.mla.attention`` around the
forward, and ``rechub.mla.attention.bwd`` around its backward.  The backward
range opens in the backward of an identity on the layer's output
(:class:`_OpenBackward`) and closes in that of an identity on its input and
the first projection's weight (:class:`_CloseBackward`), made before every
other operation of the layer.  The autograd engine runs a device's backward
nodes latest-made first, so the layer's own nodes all run between the two.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import annotate


def normal_linear(in_features: int, out_features: int, std: float, generator: Optional[torch.Generator] = None, device=None) -> nn.Linear:
    """A bias-free ``nn.Linear`` with weights ``N(0, std²)`` (the source's ``initializer_range``)."""
    layer = nn.Linear(in_features, out_features, bias=False, device=device)
    with torch.no_grad():
        layer.weight.normal_(0.0, std, generator=generator)
    return layer


class RMSNorm(nn.Module):
    """``DeepseekV2RMSNorm``: ``weight · x · rsqrt(mean(x²) + eps)``, computed in float32."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        x = x.to(torch.float32)
        x = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight * x.to(dtype)


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_correction_dim(rotations: float, dim: int, base: float, max_positions: int) -> float:
    return (dim * math.log(max_positions / (rotations * 2 * math.pi))) / (2 * math.log(base))


def yarn_inv_freq(dim: int, base: float, scaling: dict) -> torch.Tensor:
    """The ``dim / 2`` inverse frequencies of ``DeepseekV2YarnRotaryEmbedding`` (float32, on the CPU)."""
    exponents = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    freq_extra = 1.0 / (base**exponents)
    freq_inter = 1.0 / (scaling["factor"] * base**exponents)
    low = max(math.floor(yarn_correction_dim(scaling["beta_fast"], dim, base, scaling["original_max_position_embeddings"])), 0)
    high = min(math.ceil(yarn_correction_dim(scaling["beta_slow"], dim, base, scaling["original_max_position_embeddings"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    mask = 1.0 - ramp
    return freq_inter * (1 - mask) + freq_extra * mask


def yarn_cos_sin(length: int, dim: int, base: float, scaling: dict, device=None):
    """``(cos, sin)`` of shape ``(length, dim)`` at positions ``0 .. length-1``, scaled by YaRN's ``_mscale``."""
    inv_freq = yarn_inv_freq(dim, base, scaling)
    freqs = torch.outer(torch.arange(length, dtype=torch.float32), inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)
    m = yarn_mscale(scaling["factor"], scaling.get("mscale", 1)) / yarn_mscale(scaling["factor"], scaling.get("mscale_all_dim", 0))
    return (emb.cos() * m).to(device), (emb.sin() * m).to(device)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat((-x[..., half:], x[..., :half]), dim=-1)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x (B, H, L, r)``: interleaved pairs to halves, then the rotation at each position."""
    b, h, l, r = x.shape
    x = x.reshape(b, h, l, r // 2, 2).transpose(4, 3).reshape(b, h, l, r)
    return x * cos + rotate_half(x) * sin


def softmax_scale(cfg: dict) -> float:
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    scaling = cfg.get("rope_scaling")
    if scaling and scaling.get("mscale_all_dim", 0):
        m = yarn_mscale(scaling["factor"], scaling["mscale_all_dim"])
        scale = scale * m * m
    return scale


class _OpenBackward(torch.autograd.Function):
    """The identity; its backward opens the span ``name`` and leaves it in ``spans`` for :class:`_CloseBackward`."""

    @staticmethod
    def forward(ctx, y, spans: list, name: str):
        ctx.spans, ctx.name = spans, name
        ctx.set_materialize_grads(False)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        span = annotate(ctx.name)
        span.__enter__()
        ctx.spans.append(span)
        return grad, None, None


class _CloseBackward(torch.autograd.Function):
    """The identity on ``xs``; its backward closes the spans that :class:`_OpenBackward` opened."""

    @staticmethod
    def forward(ctx, spans: list, *xs):
        ctx.spans = spans
        ctx.set_materialize_grads(False)  # an input that takes no gradient gets none, not zeros
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        while ctx.spans:
            ctx.spans.pop().__exit__(None, None, None)
        return (None,) + grads


class MLA(nn.Module):
    """``DeepseekV2Attention`` without a query LoRA (module docstring); ``forward(x, valid)`` with ``valid (B, L)``
    the positions that hold an item."""

    def __init__(self, cfg: dict, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if cfg.get("q_lora_rank") is not None or (cfg.get("rope_scaling") or {}).get("type") != "yarn":
            raise NotImplementedError("MLA with a query LoRA or without YaRN rotary positions: DeepSeek-V2-Lite has neither")
        d, h = cfg["hidden_size"], cfg["num_attention_heads"]
        self.h, self.nope, self.rope, self.dv, self.c = h, cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
        self.theta, self.scaling, self.scale = float(cfg.get("rope_theta", 10000.0)), cfg.get("rope_scaling"), softmax_scale(cfg)
        std = cfg.get("initializer_range", 0.02)
        self.q_proj = normal_linear(d, h * (self.nope + self.rope), std, generator, device)
        self.kv_a_proj_with_mqa = normal_linear(d, self.c + self.rope, std, generator, device)
        self.kv_a_layernorm = RMSNorm(self.c, cfg.get("rms_norm_eps", 1e-6), device)
        self.kv_b_proj = normal_linear(self.c, h * (self.nope + self.dv), std, generator, device)
        self.o_proj = normal_linear(h * self.dv, d, std, generator, device)
        self._rotary = {}  # (length, device) -> (cos, sin)

    def rotary(self, length: int, device):
        key = (length, str(device))
        if key not in self._rotary:
            self._rotary[key] = yarn_cos_sin(length, self.rope, self.theta, self.scaling, device)
        return self._rotary[key]

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        with annotate("rechub.mla.attention"):
            w_q, spans = self.q_proj.weight, []
            marked = torch.is_grad_enabled() and (x.requires_grad or w_q.requires_grad)
            if marked:  # the backward's span: closed here, after every other node of the layer
                x, w_q = _CloseBackward.apply(spans, x, w_q)
            b, l, _ = x.shape
            h, n, r, dv = self.h, self.nope, self.rope, self.dv
            q = F.linear(x, w_q).view(b, l, h, n + r).transpose(1, 2)
            q_nope, q_pe = torch.split(q, [n, r], dim=-1)
            ckv, k_pe = torch.split(self.kv_a_proj_with_mqa(x), [self.c, r], dim=-1)
            k_pe = k_pe.view(b, l, 1, r).transpose(1, 2)
            kv = self.kv_b_proj(self.kv_a_layernorm(ckv)).view(b, l, h, n + dv).transpose(1, 2)
            k_nope, v = torch.split(kv, [n, dv], dim=-1)
            cos, sin = self.rotary(l, x.device)
            q_pe, k_pe = apply_rotary(q_pe, cos, sin), apply_rotary(k_pe, cos, sin)
            query = torch.cat([q_nope, q_pe], dim=-1)
            key = torch.cat([k_nope, k_pe.expand(b, h, l, r)], dim=-1)
            scores = torch.matmul(query, key.transpose(2, 3)) * self.scale
            allowed = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()[None, None] & valid[:, None, None, :]
            scores = scores.masked_fill(~allowed, torch.finfo(scores.dtype).min)
            attn = torch.softmax(scores, dim=-1, dtype=torch.float32).to(query.dtype)
            out = torch.matmul(attn, v).transpose(1, 2).reshape(b, l, h * dv)
            out = self.o_proj(out * valid[..., None].to(out.dtype))  # a padding query's output is zero
            return _OpenBackward.apply(out, spans, "rechub.mla.attention.bwd") if marked else out
