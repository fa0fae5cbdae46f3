"""HLLM: hierarchical LLM recommender (the User-LLM part).

Counterpart of ``torch_rechub_tpu/models/generative/hllm.py``: frozen
pre-computed LLM item embeddings (L2-normalised once in numpy fp32, a
registered buffer that no optimizer and no autograd sees, and that the
``state_dict`` keeps, as the JAX package keeps its ``constants``
collection), pre-norm causal softmax blocks with the bucketed
relative-position bias of ``RelPosBias``, time-bucket embeddings, and the
cosine head ``cos(x, emb) / temperature``.

The attention is written out (einsum, softmax, dropout masks from the
``generator`` given to ``forward``): ``scaled_dot_product_attention`` draws
its dropout from torch's global RNG.  Dropout is active in ``train()`` mode.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ...basic.attention import LayerNorm
from ...basic.hstu import dropout
from ...basic.initializers import linear, xavier_uniform_
from ...basic.precision import einsum, weak
from ...utils.hstu_utils import RelPosBias, bucketize_time


class HLLMTransformerBlock(nn.Module):
    """Pre-norm block: ``x + Drop(W_O(Drop(softmax(QKᵀ/√hd + bias))·V))``, then ``x + Drop(Dense_1(Drop(relu(Dense_0(norm2(x))))))``.

    Positions above the diagonal get ``-inf``; the bias is added inside the
    causal mask only."""

    def __init__(self, d_model: int = 512, n_heads: int = 8, dropout: float = 0.1, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.n_heads, self.dropout = n_heads, dropout
        self.norm1 = LayerNorm(d_model, eps=1e-5, device=device)
        for name in ("W_Q", "W_K", "W_V", "W_O"):
            self.add_module(name, linear(d_model, d_model, generator, device))
        self.norm2 = LayerNorm(d_model, eps=1e-5, device=device)
        self.Dense_0 = linear(d_model, 4 * d_model, generator, device)
        self.Dense_1 = linear(4 * d_model, d_model, generator, device)

    def forward(self, x: torch.Tensor, rel_pos_bias: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, l, d = x.shape
        h = self.n_heads
        hd = d // h
        p, training = self.dropout, self.training
        residual = x
        x = self.norm1(x)
        q, k, v = (m(x).reshape(b, l, h, hd).transpose(1, 2) for m in (self.W_Q, self.W_K, self.W_V))
        scores = torch.einsum("bhld,bhmd->bhlm", q, k)
        scores = scores * weak(scores, hd**-0.5)
        causal = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~causal, float("-inf"))
        if rel_pos_bias is not None:
            scores = scores + torch.where(causal, rel_pos_bias, 0.0)
        attn = dropout(torch.softmax(scores, dim=-1), p, training, generator)
        out = einsum("bhlm,bhmd->bhld", attn, v).transpose(1, 2).reshape(b, l, d)  # f32 attn (the f32 bias) promotes v
        x = residual + dropout(self.W_O(out), p, training, generator)

        residual = x
        x = dropout(torch.relu(self.Dense_0(self.norm2(x))), p, training, generator)
        return residual + dropout(self.Dense_1(x), p, training, generator)


class HLLMModel(nn.Module):
    """``forward(seq_tokens, time_diffs=None, return_hidden=False, generator=None)``: ``(B, L, V)`` cosine logits over
    the frozen table divided by ``temperature``, or ``{"hidden", "weight", "bias"}`` (the normalised hidden states,
    the table, None) for the chunked and sampled losses, which fold the temperature in."""

    def __init__(self, item_embeddings, vocab_size: int, d_model: int = 512, n_heads: int = 8, n_layers: int = 4, max_seq_len: int = 256, dropout: float = 0.1, use_rel_pos_bias: bool = True, use_time_embedding: bool = True, num_time_buckets: int = 2048, time_bucket_fn: str = "sqrt", temperature: float = 0.07, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        emb = np.asarray(item_embeddings, dtype=np.float32)
        if emb.shape[0] != vocab_size:
            raise ValueError(f"item_embeddings.shape[0]={emb.shape[0]} != vocab_size={vocab_size}")
        if emb.shape[1] != d_model:
            raise ValueError(f"item_embeddings.shape[1]={emb.shape[1]} != d_model={d_model}")
        normed = emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-8)
        self.register_buffer("item_embeddings", torch.from_numpy(normed).to(device))
        self.vocab_size, self.d_model, self.max_seq_len = vocab_size, d_model, max_seq_len
        self.dropout, self.temperature = dropout, temperature
        self.use_time_embedding, self.num_time_buckets, self.time_bucket_fn = use_time_embedding, num_time_buckets, time_bucket_fn

        self.position_embedding = xavier_uniform_(nn.Parameter(torch.empty(max_seq_len, d_model, device=device)), generator)
        if use_time_embedding:
            self.time_embedding = xavier_uniform_(nn.Parameter(torch.empty(num_time_buckets + 1, d_model, device=device)), generator)
            with torch.no_grad():
                self.time_embedding[0].zero_()
        self.rel_pos_bias = RelPosBias(n_heads, max_seq_len, generator=generator, device=device) if use_rel_pos_bias else None
        for i in range(n_layers):
            self.add_module(f"block_{i}", HLLMTransformerBlock(d_model, n_heads, dropout, generator, device))
        self.n_layers = n_layers

    def forward(self, seq_tokens: torch.Tensor, time_diffs: Optional[torch.Tensor] = None, return_hidden: bool = False, generator: Optional[torch.Generator] = None):
        b, l = seq_tokens.shape
        if l > self.max_seq_len:
            raise ValueError(f"Input seq_len ({l}) exceeds max_seq_len ({self.max_seq_len}).")
        table = self.item_embeddings
        x = table[seq_tokens.to(torch.int64)] + self.position_embedding[None, :l, :]
        if self.use_time_embedding:
            td = time_diffs if time_diffs is not None else torch.zeros((b, l), dtype=torch.int32, device=x.device)
            buckets = torch.clamp(bucketize_time(td, self.num_time_buckets, self.time_bucket_fn, 1.0, "minutes"), 0, self.num_time_buckets - 1)
            x = x + self.time_embedding[buckets]
        x = dropout(x, self.dropout, self.training, generator)

        bias = self.rel_pos_bias(l) if self.rel_pos_bias is not None else None
        for i in range(self.n_layers):
            x = getattr(self, f"block_{i}")(x, bias, generator)

        x = x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-8)
        if return_hidden:
            return {"hidden": x, "weight": table, "bias": None}
        return torch.einsum("bld,vd->blv", x, table) / self.temperature

    def output_rows(self, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids`` of the frozen normalised table: the sampled softmax's candidate rows."""
        return self.item_embeddings[ids]
