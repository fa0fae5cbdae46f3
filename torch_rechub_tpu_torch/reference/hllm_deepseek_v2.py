"""Plain PyTorch HLLM user model on DeepSeek-V2's block: the forward, the sampled softmax, the balance loss, Adam.

Written from DeepSeek-V2's ``modeling_deepseek.py`` (``DeepseekV2Attention``,
``DeepseekV2YarnRotaryEmbedding``, ``MoEGate``, ``DeepseekV2MoE``,
``DeepseekV2MLP``, ``DeepseekV2RMSNorm``) and HLLM (arXiv:2409.12740), in
float32 with TF32 off, with no kernel, sort, grouped dispatch or batching
trick.  It imports nothing but ``torch``, so that it stands apart from the
program it checks.  For a history ``x`` of item embeddings (the frozen
table's rows, each divided by its norm), ``valid`` the positions that hold
an item (id not 0):

- each layer ``i``: ``x + MLA(RMSNorm(x))``, then ``x + MLP(RMSNorm(x))``;
  layers ``i < first_k_dense_replace`` take the gated MLP
  ``down(silu(gate(x)) · up(x))`` of width ``intermediate_size``, the rest the
  expert layer; then ``RMSNorm`` and ``x / |x|`` (``RMSNorm(x) = w · x ·
  rsqrt(mean(x²) + eps)``);
- MLA: ``q = x W_q`` split per head ``nope | rope``; ``x W_kva`` split
  ``c | k_rope`` (one rotary key for every head); ``RMSNorm(c) W_kvb`` split
  per head ``k_nope | v``; the rotary halves, after the interleave-to-halves
  permutation, turned by YaRN's angles at positions ``0 .. L-1``;
  ``softmax(q·kᵀ · (n + r)^-0.5 · mscale² ; causal, padding keys masked) · v``,
  then ``W_o``; a padding query's output is zero;
- the expert layer: scores ``s = softmax(x W_gateᵀ)`` over all ``E`` experts
  in float32, the greedy top ``k`` with weights ``s`` times
  ``routed_scaling_factor``; for each held expert ``e``, the valid rows
  whose top ``k`` holds ``e`` are taken by a boolean index, put through
  ``e``'s gated MLP and added back times their weight; plus the shared
  experts, one gated MLP of width ``n_shared_experts · moe_intermediate_size``;
- the balance loss of a layer: ``α · mean_b Σ_e ce[b, e] · P[b, e]``, where
  over the valid positions of history ``b`` ``ce`` counts the picks of
  ``e`` over ``T_b · k / E`` and ``P`` is the mean score of ``e``;
- the loss: each valid position's next item (the target at the last)
  against ``num_negatives`` uniform negatives over ``[1, V)``, cosine logits
  over ``temperature``, a negative equal to the label masked out, the mean
  over valid positions.  The objective is the loss plus every layer's
  balance loss (the source's ``AddAuxiliaryLoss``); the loss read is the
  first alone.

Departure from the source: padding positions are routed to no expert and
are left out of the balance loss (the source pre-trains without padding).

The held experts are ``held_experts = (first, count)`` of ``n_routed_experts``:
the layer computes its own experts' part of the result, as one card of an
expert-parallel group does, and the reference is given the same share.

Routing ties.  The program and this reference compute the router's
logits from inputs that differ by rounding, so where a position's ``k``-th
and ``k+1``-th logits are within rounding of each other the two may pick
different experts, and a moved pair changes that expert's gradient by a
whole row.  ``route`` may therefore take the program's choice for a
position (``given``), but only where every expert of that choice has a
reference logit within :data:`ROUTING_TIE_MARGIN` of the reference's own
``k``-th largest; everywhere else it routes by its own logits.  It counts
the positions where it took the given choice (substituted) and those where
a different choice was given and refused.

``ROUTING_TIE_MARGIN`` is ``n · u`` for ``n = 2048`` (the router's dot
products' length) and ``u = 2^-24`` (float32's unit roundoff): the standard
bound on the relative error of a float32 dot product of that length, taken
against logits whose magnitude is of order one.  It is far below the gaps a
routing fault makes (a wrong expert's logit is typically a tenth or more
from the ``k``-th).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

ROUTING_TIE_MARGIN = 2048 * 2.0**-24
BETA1, BETA2, EPS = 0.9, 0.999, 1e-8
NEG_FILL = -1e30  # a negative equal to the label


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def gated_mlp(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    return F.silu(x @ gate.t()) * (x @ up.t()) @ down.t()


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def rotary_cos_sin(length: int, cfg: dict, device):
    """YaRN's ``(cos, sin)`` of shape ``(length, r)``, written out from ``DeepseekV2YarnRotaryEmbedding``."""
    r, base, y = cfg["qk_rope_head_dim"], float(cfg["rope_theta"]), cfg["rope_scaling"]

    def correction_dim(rotations):
        return r * math.log(y["original_max_position_embeddings"] / (rotations * 2 * math.pi)) / (2 * math.log(base))

    low, high = max(math.floor(correction_dim(y["beta_fast"])), 0), min(math.ceil(correction_dim(y["beta_slow"])), r - 1)
    if low == high:
        high += 0.001
    i = torch.arange(r // 2, dtype=torch.float32)
    extrapolated = 1.0 / base ** (2 * i / r)
    interpolated = extrapolated / y["factor"]
    keep = 1.0 - torch.clamp((i - low) / (high - low), 0, 1)  # 1 keeps the extrapolated frequency
    inv_freq = interpolated * (1 - keep) + extrapolated * keep
    angles = torch.arange(length, dtype=torch.float32)[:, None] * inv_freq[None, :]
    angles = torch.cat([angles, angles], dim=-1)
    m = yarn_mscale(y["factor"], y["mscale"]) / yarn_mscale(y["factor"], y["mscale_all_dim"])
    return (torch.cos(angles) * m).to(device), (torch.sin(angles) * m).to(device)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x (..., L, r)``: the interleaved pairs ``(x0, x1), (x2, x3), ..`` regrouped as halves, then turned."""
    r = x.shape[-1]
    halves = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)
    turned = torch.cat([-halves[..., r // 2:], halves[..., : r // 2]], dim=-1)
    return halves * cos + turned * sin


def latent_attention(w: Dict[str, torch.Tensor], p: str, x: torch.Tensor, valid: torch.Tensor, cfg: dict) -> torch.Tensor:
    b, l, _ = x.shape
    h, n, r, dv, c = cfg["num_attention_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    q = (x @ w[p + "q_proj.weight"].t()).reshape(b, l, h, n + r).permute(0, 2, 1, 3)
    kva = x @ w[p + "kv_a_proj_with_mqa.weight"].t()
    latent, k_rope = kva[..., :c], kva[..., c:]
    kv = (rms_norm(latent, w[p + "kv_a_layernorm.weight"], cfg["rms_norm_eps"]) @ w[p + "kv_b_proj.weight"].t()).reshape(b, l, h, n + dv).permute(0, 2, 1, 3)
    cos, sin = rotary_cos_sin(l, cfg, x.device)
    q = torch.cat([q[..., :n], rotate(q[..., n:], cos, sin)], dim=-1)
    k = torch.cat([kv[..., :n], rotate(k_rope[:, None], cos, sin).expand(b, h, l, r)], dim=-1)
    v = kv[..., n:]
    y = cfg["rope_scaling"]
    scale = (n + r) ** -0.5 * yarn_mscale(y["factor"], y["mscale_all_dim"]) ** 2
    scores = torch.einsum("bhld,bhmd->bhlm", q, k) * scale
    seen = torch.tril(torch.ones(l, l, dtype=torch.bool, device=x.device))[None, None] & valid[:, None, None, :]
    probs = torch.softmax(torch.where(seen, scores, torch.full_like(scores, torch.finfo(torch.float32).min)), dim=-1)
    out = torch.einsum("bhlm,bhmd->blhd", probs, v).reshape(b, l, h * dv) * valid[..., None].to(x.dtype)
    return out @ w[p + "o_proj.weight"].t()


def route(logits: torch.Tensor, k: int, valid: torch.Tensor, given: Optional[torch.Tensor] = None, margin: float = ROUTING_TIE_MARGIN):
    """``(ids (N, k), substituted, refused)``: the greedy top ``k`` of ``logits (N, E)``, or at valid positions the
    ``given`` choice where it is a top ``k`` up to ``margin`` (module docstring)."""
    own = torch.topk(logits, k, dim=-1).indices
    if given is None:
        return own, 0, 0
    valid_rows = valid.reshape(-1)
    if given.shape != own.shape:
        return own, 0, int(valid_rows.sum())
    given = given.to(own.dtype)
    n_experts = logits.shape[1]
    differs = (torch.sort(own, dim=-1).values != torch.sort(given, dim=-1).values).any(dim=-1) & valid_rows
    in_range = ((given >= 0) & (given < n_experts)).all(dim=-1)
    ordered = torch.sort(given.clamp(0, n_experts - 1), dim=-1).values
    distinct = (ordered[:, 1:] != ordered[:, :-1]).all(dim=-1)
    kth = logits.gather(1, own).min(dim=-1).values
    near = (logits.gather(1, given.clamp(0, n_experts - 1)) >= kth[:, None] - margin).all(dim=-1)
    take = differs & in_range & distinct & near
    ids = torch.where(take[:, None], given, own)
    return ids, int(take.sum()), int((differs & ~take).sum())


def expert_layer(w: Dict[str, torch.Tensor], p: str, x: torch.Tensor, valid: torch.Tensor, cfg: dict, given: Optional[torch.Tensor] = None):
    """``(y, balance loss, substituted, refused)`` of one expert layer over ``x (B, L, d)``."""
    b, l, d = x.shape
    n_experts, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    first, count = cfg["held_experts"]
    flat, v = x.reshape(b * l, d), valid.reshape(b * l)
    logits = flat @ w[p + "gate.weight"].t()
    scores = torch.softmax(logits, dim=-1)
    ids, substituted, refused = route(logits.detach(), k, v, given)
    weights = scores.gather(1, ids) * cfg["routed_scaling_factor"]  # norm_topk_prob false
    y = torch.zeros_like(flat)
    for j in range(count):
        e = first + j
        hit = (ids == e) & v[:, None]
        rows = hit.any(dim=1)
        out = gated_mlp(flat[rows], w[p + "experts_gate_proj"][j], w[p + "experts_up_proj"][j], w[p + "experts_down_proj"][j])
        part = torch.zeros_like(flat)
        part[rows] = (weights * hit).sum(dim=1)[rows][:, None] * out
        y = y + part
    shared = p + "shared_experts."
    if shared + "gate_proj.weight" in w:
        y = y + gated_mlp(flat, w[shared + "gate_proj.weight"], w[shared + "up_proj.weight"], w[shared + "down_proj.weight"])
    # the sequence-wise balance loss over valid positions
    vf = valid.to(torch.float32)
    picks = F.one_hot(ids.reshape(b, l, k), n_experts).to(torch.float32) * vf[..., None, None]
    positions = vf.sum(dim=1)
    ce = picks.sum(dim=(1, 2)) / (positions[:, None] * k / n_experts)
    mean_scores = (scores.reshape(b, l, n_experts) * vf[..., None]).sum(dim=1) / positions[:, None]
    aux = cfg["aux_loss_alpha"] * (ce * mean_scores).sum(dim=1).mean()
    return y.reshape(b, l, d), aux, substituted, refused


def user_states(w: Dict[str, torch.Tensor], table: torch.Tensor, tokens: torch.Tensor, cfg: dict, routes: Optional[List[torch.Tensor]] = None):
    """``(hidden (B, L, d) of unit norm, [balance losses], substituted, refused)``; ``routes`` one given choice an expert
    layer (``(B·L, k)`` ids, or None)."""
    valid = tokens != 0
    x = table[tokens]
    auxes, substituted, refused, m = [], 0, 0, 0
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        x = x + latent_attention(w, p + "self_attn.", rms_norm(x, w[p + "input_layernorm.weight"], cfg["rms_norm_eps"]), valid, cfg)
        h = rms_norm(x, w[p + "post_attention_layernorm.weight"], cfg["rms_norm_eps"])
        if i < cfg["first_k_dense_replace"]:
            x = x + gated_mlp(h, w[p + "mlp.gate_proj.weight"], w[p + "mlp.up_proj.weight"], w[p + "mlp.down_proj.weight"])
        else:
            given = None if routes is None else routes[m]
            y, aux, s, r = expert_layer(w, p + "mlp.", h, valid, cfg, given)
            x, m = x + y, m + 1
            auxes.append(aux)
            substituted, refused = substituted + s, refused + r
    x = rms_norm(x, w["norm.weight"], cfg["rms_norm_eps"])
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-8), auxes, substituted, refused


def normalised_table(table: torch.Tensor) -> torch.Tensor:
    """The frozen item table as the model reads it: each row over its norm (at least 1e-8), in place."""
    return table.div_(torch.clamp_min(torch.linalg.vector_norm(table, dim=-1, keepdim=True), 1e-8))


def negatives(gen: torch.Generator, vocab: int, count: int, device) -> torch.Tensor:
    """Shared uniform negatives over ``[1, V)``: ``randint(0, V - 1)`` shifted past PAD."""
    return torch.randint(0, vocab - 1, (count,), generator=gen, device=device) + 1


def sampled_softmax_loss(hidden, table, tokens, targets, negs, cfg) -> torch.Tensor:
    labels = torch.cat([tokens[:, 1:], targets[:, None]], dim=1)
    labels = torch.where(tokens == 0, torch.zeros_like(labels), labels)
    t = cfg["temperature"]
    pos = (hidden * table[labels]).sum(-1) / t
    neg = hidden @ table[negs].t() / t
    if cfg["logq_correction"]:
        neg = neg - math.log(negs.shape[0] / (table.shape[0] - 1.0))
    if cfg["remove_accidental_hits"]:
        neg = neg.masked_fill(negs[None, None, :] == labels[..., None], NEG_FILL)
    logp = torch.log_softmax(torch.cat([pos[..., None], neg], dim=-1), dim=-1)[..., 0]
    mask = (labels != 0).to(logp.dtype)
    return -(logp * mask).sum() / mask.sum()


def adam_step(p: torch.Tensor, g: torch.Tensor, state: dict, step: int, lr: float, weight_decay: float) -> torch.Tensor:
    """Adam with the weight decay added to the gradient, in place; returns that gradient."""
    g = g + weight_decay * p
    m = state["m"] = BETA1 * state.get("m", torch.zeros_like(p)) + (1 - BETA1) * g
    v = state["v"] = BETA2 * state.get("v", torch.zeros_like(p)) + (1 - BETA2) * g * g
    p -= lr * (m / (1 - BETA1**step)) / (torch.sqrt(v / (1 - BETA2**step)) + EPS)
    return g


def train(weights: Dict[str, torch.Tensor], table: torch.Tensor, batches: List[dict], cfg: dict, negatives_gen: torch.Generator, routes: Optional[List[List[torch.Tensor]]] = None, allow_tf32: bool = False) -> dict:
    """``len(batches)`` steps of Adam on every leaf of ``weights`` (changed in place), from ``table`` normalised.

    TF32 is off while it runs (``allow_tf32=True`` runs it in TF32, the
    precision below float32, as a control that has to fail the comparison).

    ``routes``: per step, the program's choice of each expert layer (or
    None).  Returns ``{"losses", "first_grad_norms", "balance_losses",
    "substituted", "refused"}``: each step's loss, each leaf's gradient norm
    on the first step as Adam takes it, each step's summed balance loss, and
    the routing ties taken or refused over the steps.
    """
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    state: Dict[str, dict] = {}
    out = {"losses": [], "first_grad_norms": {}, "balance_losses": [], "substituted": 0, "refused": 0}
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = allow_tf32
    try:
        if not torch.is_grad_enabled():
            raise RuntimeError("the reference trains with autograd on")
        for step, batch in enumerate(batches, start=1):
            params = {n: t.detach().requires_grad_() for n, t in weights.items()}
            negs = negatives(negatives_gen, table.shape[0], cfg["num_negatives"], batch["tokens"].device)
            hidden, auxes, s, r = user_states(params, table, batch["tokens"], cfg, None if routes is None else routes[step - 1])
            loss = sampled_softmax_loss(hidden, table, batch["tokens"], batch["targets"], negs, cfg)
            balance = torch.stack(auxes).sum() if auxes else torch.zeros((), device=loss.device)
            grads = dict(zip(params, torch.autograd.grad(loss + balance, list(params.values()))))
            del params, hidden
            out["losses"].append(float(loss.detach()))
            out["balance_losses"].append(float(balance.detach()))
            out["substituted"] += s
            out["refused"] += r
            with torch.no_grad():
                for n, g in grads.items():
                    g = adam_step(weights[n], g, state.setdefault(n, {}), step, cfg["lr"], cfg["weight_decay"])
                    if step == 1:
                        out["first_grad_norms"][n] = float(torch.linalg.vector_norm(g))
            del grads
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return out
