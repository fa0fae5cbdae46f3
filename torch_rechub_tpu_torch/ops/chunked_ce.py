"""Chunked large-vocabulary cross-entropy and the sampled softmax.

Counterpart of ``torch_rechub_tpu/ops/chunked_ce.py``: the next-token CE
computed without ever forming the ``(B, L, V)`` logits.  The target logit
is a direct gather, and the log-sum-exp is accumulated online over vocab
chunks whose body runs under ``torch.utils.checkpoint`` (``jax.checkpoint``
in the reference), so peak memory is ``B*L*chunk`` in the forward and the
backward.  Semantics: labels are ``concat(seq[1:], target)``, positions
whose current token is PAD are masked, and the PAD column is left out of
the partition function.

The sampled softmax estimates the partition from the target and
``num_negatives`` shared uniform negatives; the negatives come from a
``torch.Generator`` the caller owns (the trainer's).
"""

from __future__ import annotations

from typing import Optional

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..basic.precision import weak

_NEG_INF = -1e30


def _lse_chunk(m, s, hidden, w_c, b_c, inv_t: float, pad_col: Optional[int]):
    """One chunk's online log-sum-exp update of the running ``(max, sum)``."""
    logits = hidden @ w_c.T
    if b_c is not None:
        logits = logits + b_c
    logits = (logits * inv_t).to(torch.float32)
    if pad_col is not None:  # the ignored column, as an offset into this chunk
        valid = torch.arange(w_c.shape[0], device=hidden.device) != pad_col
        logits = torch.where(valid, logits, torch.full_like(logits, _NEG_INF))
    cm = torch.maximum(m, logits.amax(dim=-1))
    e = torch.exp(logits - cm[..., None])
    if pad_col is not None:
        e = torch.where(valid, e, torch.zeros_like(e))
    return cm, s * torch.exp(m - cm) + e.sum(dim=-1)


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
    weight = weight.to(hidden.dtype)  # the products in the compute dtype; the accumulators in f32
    inv_t = weak(hidden, 1.0 / temperature)  # rounded to bf16 under the policy, as there
    m = torch.full(hidden.shape[:-1], _NEG_INF, dtype=torch.float32, device=hidden.device)
    s = torch.zeros(hidden.shape[:-1], dtype=torch.float32, device=hidden.device)
    # under autograd each chunk's logits are recomputed in the backward, not kept
    remat = torch.is_grad_enabled()
    for start in range(0, v, chunk_size):
        w_c = weight[start:start + chunk_size]
        b_c = None if bias is None else bias[start:start + chunk_size]
        pad_col = ignore_index - start if ignore_index is not None and start <= ignore_index < start + w_c.shape[0] else None
        if remat:
            m, s = checkpoint(_lse_chunk, m, s, hidden, w_c, b_c, inv_t, pad_col, use_reentrant=False)
        else:
            m, s = _lse_chunk(m, s, hidden, w_c, b_c, inv_t, pad_col)
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


def sampled_candidates(seq_tokens: torch.Tensor, targets: torch.Tensor, generator: Optional[torch.Generator], vocab_size: int, num_negatives: int, ignore_index: int = 0):
    """``(next_tokens (B, L), negs (S,))``: the candidate ids of the sampled loss.

    Negatives are uniform over the vocab without ``ignore_index``, drawn from
    ``generator`` (which lies on ``seq_tokens``' device): ``[0, V-1)`` with
    the ids at or above ``ignore_index`` shifted up by one.
    """
    next_tokens = shifted_labels(seq_tokens, targets, ignore_index)
    r = torch.randint(0, vocab_size - 1, (num_negatives,), generator=generator, device=seq_tokens.device)
    return next_tokens, r + (r >= ignore_index).to(r.dtype)


def sampled_loss_from_rows(hidden, w_pos, w_neg, b_pos, b_neg, next_tokens, negs, vocab_size: int, temperature: float = 1.0, ignore_index: int = 0, remove_accidental_hits: bool = True, logq_correction: bool = True) -> torch.Tensor:
    """Sampled-softmax loss from the gathered candidate rows.

    ``w_pos (B, L, D)`` are the label rows, ``w_neg (S, D)`` the shared
    negatives'.  Temperature first, then the logQ shift ``log(S/(V-1))`` of
    the negative logits; negatives equal to a position's label are masked.
    """
    num_negatives = negs.shape[0]
    logits_pos = torch.einsum("bld,bld->bl", hidden, w_pos.to(hidden.dtype)).to(torch.float32)
    logits_neg = torch.einsum("bld,sd->bls", hidden, w_neg.to(hidden.dtype)).to(torch.float32)
    if b_pos is not None:
        logits_pos = logits_pos + b_pos
        logits_neg = logits_neg + b_neg
    logits_pos = logits_pos / temperature
    logits_neg = logits_neg / temperature
    if logq_correction:
        logits_neg = logits_neg - math.log(num_negatives / (vocab_size - 1.0))
    if remove_accidental_hits:
        hit = negs[None, None, :] == next_tokens[..., None]
        logits_neg = torch.where(hit, torch.full_like(logits_neg, _NEG_INF), logits_neg)
    logits = torch.cat([logits_pos[..., None], logits_neg], dim=-1)
    logp_target = torch.log_softmax(logits, dim=-1)[..., 0]
    mask = (next_tokens != ignore_index).to(torch.float32)
    return -torch.sum(logp_target * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def sampled_next_token_loss(hidden, weight, seq_tokens, targets, generator: Optional[torch.Generator], bias=None, temperature: float = 1.0, ignore_index: int = 0, num_negatives: int = 1024, remove_accidental_hits: bool = True, logq_correction: bool = True) -> torch.Tensor:
    """Sampled-softmax next-token loss: one ``(S, D)`` gather and one
    ``(B*L, D) @ (D, S)`` product per step, whatever the vocab size."""
    v = weight.shape[0]
    next_tokens, negs = sampled_candidates(seq_tokens, targets, generator, v, num_negatives, ignore_index)
    b_pos = bias[next_tokens] if bias is not None else None
    b_neg = bias[negs] if bias is not None else None
    return sampled_loss_from_rows(hidden, weight[next_tokens], weight[negs], b_pos, b_neg, next_tokens, negs, v, temperature, ignore_index, remove_accidental_hits, logq_correction)
