"""Chunked large-vocabulary cross-entropy (forward).

Counterpart of ``torch_rechub_tpu/ops/chunked_ce.py``: the next-token CE
computed without ever forming the ``(B, L, V)`` logits.  The target logit
is a direct gather, and the log-sum-exp is accumulated online over vocab
chunks, so peak memory is ``B*L*chunk``.  Semantics: labels are
``concat(seq[1:], target)``, positions whose current token is PAD are
masked, and the PAD column is left out of the partition function.

Only the forward is ported; the training slice adds activation
checkpointing of the chunk loop (``jax.checkpoint`` in the reference).
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30


def chunked_logsumexp(hidden: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None, temperature: float = 1.0, ignore_index: Optional[int] = 0, chunk_size: int = 8192) -> torch.Tensor:
    """``logsumexp(hidden @ weight.T (+bias) / T, dim=-1)`` over vocab chunks.

    Args:
        hidden: ``(..., D)``; weight: ``(V, D)``; bias: optional ``(V,)``.
        ignore_index: vocab column left out of the partition (``None`` keeps all).
        chunk_size: vocab tile; peak memory is ``prod(batch dims) * chunk_size``.

    Returns ``(...,)`` float32 log-partition values.
    """
    v = weight.shape[0]
    chunk_size = min(chunk_size, v)
    weight = weight.to(hidden.dtype)
    inv_t = 1.0 / temperature
    m = torch.full(hidden.shape[:-1], _NEG_INF, dtype=torch.float32, device=hidden.device)
    s = torch.zeros(hidden.shape[:-1], dtype=torch.float32, device=hidden.device)
    for start in range(0, v, chunk_size):
        w_c = weight[start:start + chunk_size]
        logits = hidden @ w_c.T
        if bias is not None:
            logits = logits + bias[start:start + chunk_size]
        logits = (logits * inv_t).to(torch.float32)
        if ignore_index is not None and start <= ignore_index < start + w_c.shape[0]:
            valid = torch.arange(start, start + w_c.shape[0], device=hidden.device) != ignore_index
            logits = torch.where(valid, logits, torch.full_like(logits, _NEG_INF))
            e_mask = valid
        else:
            e_mask = None
        cm = torch.maximum(m, logits.amax(dim=-1))
        e = torch.exp(logits - cm[..., None])
        if e_mask is not None:
            e = torch.where(e_mask, e, torch.zeros_like(e))
        s = s * torch.exp(m - cm) + e.sum(dim=-1)
        m = cm
    return m + torch.log(torch.clamp_min(s, 1e-30))


def shifted_labels(seq_tokens: torch.Tensor, targets: torch.Tensor, ignore_index: int = 0) -> torch.Tensor:
    """``concat(seq[1:], target)`` with the label of every PAD position set to ``ignore_index``."""
    next_tokens = torch.cat([seq_tokens[:, 1:], targets[:, None].to(seq_tokens.dtype)], dim=1)
    return torch.where(seq_tokens == ignore_index, torch.full_like(next_tokens, ignore_index), next_tokens).to(torch.int64)


def chunked_next_token_loss(hidden: torch.Tensor, weight: torch.Tensor, seq_tokens: torch.Tensor, targets: torch.Tensor, bias: Optional[torch.Tensor] = None, temperature: float = 1.0, ignore_index: int = 0, chunk_size: int = 8192) -> torch.Tensor:
    """Shifted next-token CE, equal to ``next_token_loss`` on dense logits.

    ``hidden`` is ``(B, L, D)`` (already score-normalised if the model
    L2-normalises); ``temperature`` is the combined logits divisor.
    """
    next_tokens = shifted_labels(seq_tokens, targets, ignore_index)
    w_t = weight[next_tokens].to(hidden.dtype)
    logit_t = torch.einsum("bld,bld->bl", hidden, w_t).to(torch.float32)
    if bias is not None:
        logit_t = logit_t + bias[next_tokens]
    logit_t = logit_t / temperature

    lse = chunked_logsumexp(hidden, weight, bias, temperature, ignore_index, chunk_size)
    nll = lse - logit_t
    mask = (next_tokens != ignore_index).to(nll.dtype)
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def chunked_last_logits(hidden_last: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None, temperature: float = 1.0) -> torch.Tensor:
    """Dense ``(B, V)`` logits for the last position only (eval / top-k)."""
    logits = (hidden_last @ weight.to(hidden_last.dtype).T).to(torch.float32)
    if bias is not None:
        logits = logits + bias
    return logits / temperature
