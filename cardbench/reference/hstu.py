"""Plain PyTorch HSTU (arXiv:2402.17152): the forward, the sampled softmax, and the training update.

Written from the paper and the model's documented semantics, with no
kernel, cache or batching trick, in float32.  It follows the port's model
where the paper leaves a choice open, and says so:

- Eq. 2: one SiLU on the joint projection, split as q | k | u | v;
- Eq. 3: ``silu(alpha q.k + rab) / max_seq_len`` with no softmax; the
  relative bias is a position table indexed by ``j - i + max_seq_len - 1``
  plus a time table indexed by the bucket of ``|t_i - t_j|`` (``bucketize``:
  ``sqrt`` or ``log`` of seconds or minutes, over a divisor), cut at
  ``num_time_buckets``; pairs after the query or with a PAD key are filled
  with -1e4 before the SiLU;
- Eq. 4: ``proj2(LayerNorm(A V) * U)`` added to the residual stream; a
  LayerNorm before ``proj1``;
- the input: the token embedding (times ``sqrt(d)`` where the configuration
  scales it) + position (+ bucketed time-before-request, where it has a time
  embedding) embeddings, PAD positions zeroed; no dropout (the configuration
  runs at 0.0);
- scores: under ``score_norm="l2"`` the user's hidden state and each item's
  output row divided by their norms (at least ``l2_norm_eps``), logits over
  ``temperature``;
- the sampled softmax: the label's logit against shared uniform negatives
  over ``[1, V)``, where the configuration asks each shifted by
  ``-log(S / (V - 1))`` (logQ), a negative equal to the label masked out,
  the mean over non-PAD positions.

The update: Adam with weight decay added to the gradient (eps 1e-8 outside
the square root) on the dense leaves; row-wise Adagrad on the two tables,
whose accumulator adds the row's mean squared gradient, summed over the
batch's duplicates, and whose PAD row 0 never moves.

The attention runs in blocks of users (``block``) so that the reference
fits beside nothing else on the card.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from .optim import adam_step, rowwise_adagrad_step

SPARSE = ("token_embedding", "output_projection")


def bucketize(dt: torch.Tensor, cfg: dict, cap: int) -> torch.Tensor:
    """The time bucket of ``|dt|`` seconds in float32: ``sqrt`` or ``log`` of seconds or minutes (at least 1e-6), over the divisor, cut to ``[0, cap]``."""
    x = dt.to(torch.float32).abs()
    if cfg["time_bucket_unit"] == "minutes":
        x = x / 60.0
    x = torch.clamp_min(x, 1e-6)
    b = torch.sqrt(x) if cfg["time_bucket_fn"] == "sqrt" else torch.log(x)
    return torch.clamp(b / cfg["time_bucket_divisor"], 0, cap).to(torch.int64)


class TableRows(torch.autograd.Function):
    """``table[idx]``, whose backward adds the gradient rows into the table by counting
    (``torch.bincount`` with weights, a column at a time) rather than by sorting the
    indices: the time bias reads a 129-row table at every (query, key) pair."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        flat, g = idx.reshape(-1), g.reshape(idx.numel(), -1)
        return torch.stack([torch.bincount(flat, weights=g[:, c].contiguous(), minlength=ctx.rows) for c in range(g.shape[1])], dim=1), None


def layer_norm(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w, b, 1e-5)


def attention(q, k, v, pos_w, ts_w, times, valid_keys, cfg):
    """``(B, L, H, dv)`` for q, k ``(B, L, H, dqk)``, v ``(B, L, H, dv)``."""
    b, l, h, dqk = q.shape
    n, nb = cfg["max_seq_len"], cfg["num_time_buckets"]
    i = torch.arange(l, device=q.device)
    rel = i[None, :] - i[:, None] + (n - 1)
    bias = TableRows.apply(pos_w, rel).permute(2, 0, 1)[None]  # (1, H, L, L)
    dt = times[:, :, None].to(torch.int64) - times[:, None, :].to(torch.int64)
    bias = bias + TableRows.apply(ts_w, bucketize(dt, cfg, nb)).permute(0, 3, 1, 2)
    scores = torch.einsum("blhd,bmhd->bhlm", q, k) * (1.0 / math.sqrt(dqk)) + bias
    allowed = torch.tril(torch.ones((l, l), dtype=torch.bool, device=q.device))[None, None] & valid_keys[:, None, None, :]
    attn = F.silu(scores.masked_fill(~allowed, -1e4)) / n
    return torch.einsum("bhlm,bmhd->blhd", attn, v)


def hidden_states(w: Dict[str, torch.Tensor], tokens, times, cfg, block: int = 32) -> torch.Tensor:
    """The last layer's ``(B, L, d)`` output, PAD positions zeroed, computed ``block`` users at a time."""
    outs = [_hidden_block(w, tokens[s:s + block], times[s:s + block], cfg) for s in range(0, tokens.shape[0], block)]
    return torch.cat(outs)


def _hidden_block(w, tokens, times, cfg):
    b, l = tokens.shape
    h, dqk, dv, nb = cfg["n_heads"], cfg["dqk"], cfg["dv"], cfg["num_time_buckets"]
    valid = tokens != 0
    x = w["token_embedding"][tokens] * (math.sqrt(cfg["d_model"]) if cfg["scale_input_embedding"] else 1.0) + w["position_embedding"][None, :l]
    if cfg["use_time_embedding"]:
        x = x + TableRows.apply(w["time_embedding"], bucketize(times, cfg, nb - 1))
    x = x * valid[..., None].to(x.dtype)
    for li in range(cfg["n_layers"]):
        p = f"hstu_block.layers.{li}."
        proj = F.silu(F.linear(layer_norm(x, w[p + "norm_in.weight"], w[p + "norm_in.bias"]), w[p + "proj1.weight"], w[p + "proj1.bias"]))
        q, k, u, v = torch.split(proj, [h * dqk, h * dqk, h * dv, h * dv], dim=-1)
        a = attention(q.reshape(b, l, h, dqk), k.reshape(b, l, h, dqk), v.reshape(b, l, h, dv), w[p + "rab.pos_w"], w[p + "rab.ts_w"], times, valid, cfg)
        gated = layer_norm(a.reshape(b, l, h * dv), w[p + "norm_attn.weight"], w[p + "norm_attn.bias"]) * u
        x = x + F.linear(gated, w[p + "proj2.weight"], w[p + "proj2.bias"])
    return x * valid[..., None].to(x.dtype)


def score_rows(t: torch.Tensor, cfg: dict) -> torch.Tensor:
    """``t``'s rows as they enter a score: divided by their norms under ``score_norm="l2"``."""
    if cfg["score_norm"] != "l2":
        return t
    return t / torch.clamp_min(torch.linalg.vector_norm(t, dim=-1, keepdim=True), cfg["l2_norm_eps"])


def user_and_items(w: Dict[str, torch.Tensor], tokens, times, cfg) -> tuple:
    """Retrieval's two sides: each history's last hidden state and every item's output row, as they enter the score."""
    return score_rows(hidden_states(w, tokens, times, cfg)[:, -1, :], cfg), score_rows(w["output_projection"], cfg)


def negatives(gen: torch.Generator, vocab: int, count: int, device) -> torch.Tensor:
    """Shared uniform negatives over ``[1, V)``: ``randint(0, V - 1)`` shifted past PAD."""
    return torch.randint(0, vocab - 1, (count,), generator=gen, device=device) + 1


def sampled_softmax_loss(w, hidden, tokens, targets, negs, cfg) -> torch.Tensor:
    labels = torch.cat([tokens[:, 1:], targets[:, None]], dim=1)
    labels = torch.where(tokens == 0, torch.zeros_like(labels), labels)
    out, hidden = w["output_projection"], score_rows(hidden, cfg)
    pos = torch.einsum("bld,bld->bl", hidden, score_rows(out[labels], cfg)) / cfg["temperature"]
    neg = torch.einsum("bld,sd->bls", hidden, score_rows(out[negs], cfg)) / cfg["temperature"]
    if cfg["logq_correction"]:
        neg = neg - math.log(negs.shape[0] / (cfg["vocab_size"] - 1.0))
    if cfg["remove_accidental_hits"]:
        neg = neg.masked_fill(negs[None, None, :] == labels[..., None], -1e30)
    logp = torch.log_softmax(torch.cat([pos[..., None], neg], dim=-1), dim=-1)[..., 0]
    mask = (labels != 0).to(logp.dtype)
    return -(logp * mask).sum() / mask.sum()


def train(weights: Dict[str, torch.Tensor], batches: List[dict], cfg: dict, negatives_gen: torch.Generator) -> dict:
    """Run ``len(batches)`` training steps from ``weights`` (changed in place).

    Returns ``{"losses": [...], "first_grad_norms": {leaf: float}}``: the
    norm of each leaf's gradient on the first step as its optimizer takes
    it (with the weight decay for Adam's leaves).
    """
    dense = [n for n in weights if n not in SPARSE]
    adam_state, accums = {}, {n: torch.zeros(weights[n].shape[0], device=weights[n].device, dtype=weights[n].dtype) for n in SPARSE}
    losses, first = [], {}
    for step, batch in enumerate(batches, start=1):
        params = {n: t.detach().requires_grad_() for n, t in weights.items()}
        negs = negatives(negatives_gen, cfg["vocab_size"], cfg["num_negatives"], batch["tokens"].device)
        hidden = hidden_states(params, batch["tokens"], batch["times"], cfg)
        loss = sampled_softmax_loss(params, hidden, batch["tokens"], batch["targets"], negs, cfg)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        del params, hidden
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for n in dense:
                g = adam_step(weights[n], grads[n], adam_state.setdefault(n, {}), step, cfg["lr"], cfg["weight_decay"])
                if step == 1:
                    first[n] = float(torch.linalg.vector_norm(g))
            for n in SPARSE:
                g = grads[n]
                g[0] = 0.0  # PAD: the fill row takes no update
                rowwise_adagrad_step(weights[n], accums[n], g, cfg["lr"])
                if step == 1:
                    first[n] = float(torch.linalg.vector_norm(g))
        del grads
    return {"losses": losses, "first_grad_norms": first}
