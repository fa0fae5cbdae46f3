"""HSTUModel: generative sequence recommender (arXiv:2402.17152).

Counterpart of ``torch_rechub_tpu/models/generative/hstu.py``: token +
position + bucketed-time embeddings (PAD positions zeroed), an ``HSTUBlock``
stack, a tied (or separate) output projection, optional L2-normalised
scoring with a temperature, and the ``max_seq_len`` guard.  Dropout is active
in ``train()`` mode and draws from the ``generator`` given to ``forward``.

An untied model's token gather, and the gather of its output rows for the
sampled softmax (``output_rows``), are hooks of the sparse row-wise
updates: inside ``ops.sparse_update.record_rows`` they read the rows as a
recorded leaf (``SeqTrainer(sparse_embedding=...)``).  A tied table also
takes a dense gradient through the output projection, so it has no hook.

Under a device mesh the token table and the output projection may be row
shards (``parallel.mesh``): their rows are read through ``table_rows`` /
the hooks, and the logits of a shard's vocab columns are gathered over the
model group.

Under the bf16 policy the embeddings (f32 tables) are cast to bf16 after
the dropout and the stack runs in bf16; the logits are formed in bf16 and
returned in f32, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...basic.hstu import HSTUBlock, dropout
from ...basic.initializers import xavier_uniform_
from ...basic.precision import compute_dtype
from ...ops.sparse_update import gather_rows
from ...parallel.distributed import gather_replicated, replicated_input
from ...parallel.mesh import row_shard, table_rows, with_row_shard
from ...utils.hstu_utils import bucketize_time
from ...utils.profiling import annotate


class HSTUModel(nn.Module):
    # the vocab tables a device mesh may row-shard: every read of them is shard-aware
    row_shardable = ("token_embedding", "output_projection")

    def __init__(self, vocab_size: int, d_model: int = 512, n_heads: int = 8, n_layers: int = 4, dqk: int = 64, dv: int = 64, max_seq_len: int = 256, dropout: float = 0.1, use_time_embedding: bool = True, num_time_buckets: int = 128, time_bucket_fn: str = "sqrt", time_bucket_divisor: float = 1.0, time_bucket_unit: str = "minutes", tie_embeddings: bool = True, score_norm: str = "none", temperature: float = 1.0, use_output_bias: bool = True, scale_input_embedding: bool = False, l2_norm_eps: float = 1e-6, use_fused_kernel: bool = True, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if score_norm not in ("none", "l2"):
            raise ValueError("score_norm must be 'none' or 'l2'")
        self.vocab_size, self.d_model, self.max_seq_len = vocab_size, d_model, max_seq_len
        self.use_time_embedding = use_time_embedding
        self.num_time_buckets, self.time_bucket_fn = num_time_buckets, time_bucket_fn
        self.time_bucket_divisor, self.time_bucket_unit = time_bucket_divisor, time_bucket_unit
        self.tie_embeddings, self.score_norm = tie_embeddings, score_norm
        self.temperature, self.l2_norm_eps = temperature, l2_norm_eps
        self.scale_input_embedding = scale_input_embedding

        def table(rows):
            return xavier_uniform_(nn.Parameter(torch.empty(rows, d_model, device=device)), generator)

        self.token_embedding = table(vocab_size)
        with torch.no_grad():
            self.token_embedding[0].zero_()  # PAD row
        self.position_embedding = table(max_seq_len)
        self.time_embedding = table(num_time_buckets) if use_time_embedding else None
        self.dropout = dropout
        self.hstu_block = HSTUBlock(d_model, n_heads, n_layers, dqk, dv, dropout, max_seq_len, num_time_buckets, time_bucket_fn, time_bucket_divisor, time_bucket_unit, use_fused_kernel, generator=generator, device=device)
        if tie_embeddings:
            self.output_bias = nn.Parameter(torch.zeros(vocab_size, device=device)) if use_output_bias else None
        else:
            self.output_projection = table(vocab_size)
            self.output_projection_bias = nn.Parameter(torch.zeros(vocab_size, device=device)) if use_output_bias else None

    def forward(self, x: torch.Tensor, time_diffs: Optional[torch.Tensor] = None, return_hidden: bool = False, generator: Optional[torch.Generator] = None):
        with annotate("rechub.hstu.forward"):
            b, l = x.shape
            if l > self.max_seq_len:
                raise ValueError(f"Input seq_len ({l}) exceeds max_seq_len ({self.max_seq_len}).")
            x = x.to(torch.int64)
            padding_mask = x != 0

            token_emb = table_rows(self.token_embedding, x) if self.tie_embeddings else gather_rows(self.token_embedding, x)
            if self.scale_input_embedding:
                token_emb = token_emb * (self.d_model**0.5)
            emb = token_emb + self.position_embedding[None, :l, :]
            if self.use_time_embedding:
                td = time_diffs if time_diffs is not None else torch.zeros((b, l), dtype=torch.int32, device=x.device)
                buckets = bucketize_time(td, self.num_time_buckets, self.time_bucket_fn, self.time_bucket_divisor, self.time_bucket_unit, max_bucket=self.num_time_buckets - 1)
                emb = emb + self.time_embedding[buckets]
            emb = dropout(emb * padding_mask[..., None].to(emb.dtype), self.dropout, self.training, generator).to(compute_dtype())

            out = self.hstu_block(emb, padding_mask=padding_mask, time_diffs=time_diffs, generator=generator)
            out = out * padding_mask[..., None].to(out.dtype)

            if self.tie_embeddings:
                weight, bias = self.token_embedding, self.output_bias
            else:
                weight, bias = self.output_projection, self.output_projection_bias
            if self.score_norm == "l2":  # the norms in f32
                out, weight = self._l2(out.to(torch.float32)).to(out.dtype), with_row_shard(self._l2(weight), weight)

            if return_hidden:
                # for the chunked large-vocab CE: score-normalised hidden states
                # and output table; the caller folds in self.temperature
                return {"hidden": out, "weight": weight, "bias": bias}

            shard = row_shard(weight)
            if shard is not None:  # the hidden states enter this rank's vocab columns
                out = replicated_input(out, shard.group)
            logits = torch.einsum("bld,vd->blv", out, weight.to(out.dtype)).to(torch.float32)
            if shard is not None:  # every owner's columns, in order
                logits = gather_replicated(logits, shard.group, dim=-1)
            if bias is not None:
                logits = logits + bias
            if self.temperature != 1.0:
                logits = logits / self.temperature
            return logits

    def _l2(self, t: torch.Tensor) -> torch.Tensor:
        return t / torch.clamp_min(torch.linalg.vector_norm(t, dim=-1, keepdim=True), self.l2_norm_eps)

    def output_rows(self, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids`` of the output table (the token table when tied),
        L2-normalised under ``score_norm="l2"``: the sampled softmax's
        candidate rows.  An untied table's gather is a hook of the sparse
        row-wise updates, as the token gather is."""
        rows = table_rows(self.token_embedding, ids) if self.tie_embeddings else gather_rows(self.output_projection, ids)
        return self._l2(rows) if self.score_norm == "l2" else rows
