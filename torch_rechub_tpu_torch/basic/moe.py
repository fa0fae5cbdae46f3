"""DeepSeek-V2's mixture of experts, for a layer that holds a share of the experts, and its gated MLP.

Follows ``MoEGate``, ``DeepseekV2MoE``, ``AddAuxiliaryLoss`` and
``DeepseekV2MLP`` of the model's ``modeling_deepseek.py`` (greedy top-k,
softmax scores, the sequence-wise balance loss), for ``x (B, L, d)`` and
``E`` routed experts:

- ``MLP(x) = down_proj(silu(gate_proj(x)) · up_proj(x))``, no biases;
- the router, in float32: ``s = softmax(x W_gᵀ)`` over all ``E`` experts,
  ``(w, i) = topk(s, k)`` (greedy), ``w`` times ``routed_scaling_factor``
  (``norm_topk_prob`` false, as DeepSeek-V2-Lite sets it);
- the balance loss of each sequence ``b`` (``seq_aux``), ``α`` being
  ``aux_loss_alpha``: ``ce[b, e] = #{(t, j): i[b, t, j] = e} / (T_b·k / E)``
  and ``P[b, e] = mean_t s[b, t, e]``, over the ``T_b`` positions of ``b``,
  and ``aux = α · mean_b Σ_e ce[b, e]·P[b, e]``; as ``AddAuxiliaryLoss``
  does, it is not added to the layer's output but its gradient (one) joins
  the backward, so the training objective is the loss plus every layer's
  ``aux`` while the loss read stays the model's own;
- ``y = Σ_{j: i_j ∈ held} w_j · E_{i_j}(x) + shared(x)``, the shared
  experts being one MLP of width ``n_shared_experts · moe_intermediate_size``.

The layer holds the experts ``held = range(e0, e0 + n)`` of the ``E`` (the
share one card of an expert-parallel group holds).  It routes over all
``E``, computes its own experts' part for the tokens routed to them, with no
token dropped and no row padded, adds the shared experts and passes that
partial result on; the absent experts' part is the other cards' (this
layer sends nothing).

Departure from the source, which pre-trains without padding: positions that
hold no item (``valid`` false) are routed to no expert, and are left out of
the balance loss's counts ``ce`` and means ``P`` (``T_b`` counts the valid
positions alone).

Dispatch: the (token, expert) pairs that fall on held experts are sorted by
expert; the ``n`` per-expert counts are read on the host once per forward
(one synchronisation), then one product per held expert runs over exactly
its rows (:class:`_Experts`) and the results are added back with the
router's weights (:class:`_Combine`).  That host read makes the step
unsafe to capture as a CUDA graph: :class:`MoE` sets ``graph_safe = False``,
which ``trainers/graph_step.py`` reads.

Spans (``utils/profiling.py``): ``rechub.moe.route`` (the router and the
balance loss), ``rechub.moe.dispatch`` (the sort, the gather by expert, the
weighted scatter-add), ``rechub.moe.experts`` (the held experts' products);
in the backward ``rechub.moe.experts.bwd`` and ``rechub.moe.dispatch.bwd``.
Counters: ``rechub.moe.routed_pairs`` (pairs that fell on held experts) and
``rechub.moe.max_expert_pairs`` (the largest held expert's pairs), from the
counts already on the host.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import annotate, count
from .mla import normal_linear


class GatedMLP(nn.Module):
    """``DeepseekV2MLP``: ``down_proj(silu(gate_proj(x)) · up_proj(x))``, no biases."""

    def __init__(self, d: int, width: int, std: float = 0.02, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.gate_proj = normal_linear(d, width, std, generator, device)
        self.up_proj = normal_linear(d, width, std, generator, device)
        self.down_proj = normal_linear(width, d, std, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class AddAuxiliaryLoss(torch.autograd.Function):
    """The identity on ``x`` whose backward also gives ``loss`` the gradient one (the source's)."""

    @staticmethod
    def forward(ctx, x, loss):
        ctx.needs_loss = loss.requires_grad
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, (torch.ones((), dtype=torch.float32, device=grad.device) if ctx.needs_loss else None)


class MoEGate(nn.Module):
    """``MoEGate`` with greedy top-k over softmax scores and the sequence-wise balance loss (module docstring)."""

    def __init__(self, d: int, n_experts: int, top_k: int, alpha: float, scaling: float = 1.0, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.n_experts, self.top_k, self.alpha, self.scaling = n_experts, top_k, alpha, scaling
        self.weight = nn.Parameter(torch.empty(n_experts, d, device=device))
        with torch.no_grad():  # kaiming_uniform_(a=sqrt(5)): U(-1/sqrt(d), 1/sqrt(d))
            self.weight.uniform_(-(d**-0.5), d**-0.5, generator=generator)

    def forward(self, x: torch.Tensor, valid: torch.Tensor, batch: int) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """``x (N, d)`` of ``batch`` sequences, ``valid (N,)``: ``(ids (N, k), weights (N, k), aux or None)``."""
        scores = torch.softmax(F.linear(x.to(torch.float32), self.weight.to(torch.float32)), dim=-1, dtype=torch.float32)
        weights, ids = torch.topk(scores, k=self.top_k, dim=-1, sorted=False)
        weights = weights * self.scaling
        aux = seq_balance_loss(scores, ids, valid, batch, self.alpha) if self.training and self.alpha > 0 else None
        return ids, weights, aux


def seq_balance_loss(scores: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor, batch: int, alpha: float) -> torch.Tensor:
    """The source's ``seq_aux`` balance loss over the valid positions of each of ``batch`` sequences."""
    n_experts, k = scores.shape[-1], ids.shape[-1]
    scores, ids, valid = scores.view(batch, -1, n_experts), ids.view(batch, -1), valid.view(batch, -1).to(torch.float32)
    picks = valid.repeat_interleave(k, dim=1)
    positions = valid.sum(dim=1)
    ce = torch.zeros(batch, n_experts, device=scores.device).scatter_add_(1, ids, picks) / torch.clamp_min(positions * k / n_experts, 1e-20)[:, None]
    mean_scores = (scores * valid[..., None]).sum(dim=1) / torch.clamp_min(positions, 1.0)[:, None]
    seen = (positions > 0).to(torch.float32)
    return alpha * ((ce * mean_scores).sum(dim=1) * seen).sum() / torch.clamp_min(seen.sum(), 1.0)


class _Gather(torch.autograd.Function):
    """``x[tok]``; its backward adds the rows back, inside ``rechub.moe.dispatch.bwd``."""

    @staticmethod
    def forward(ctx, x, tok):
        ctx.save_for_backward(tok)
        ctx.rows = x.shape[0]
        return x[tok]

    @staticmethod
    def backward(ctx, grad):
        (tok,) = ctx.saved_tensors
        with annotate("rechub.moe.dispatch.bwd"):
            return grad.new_zeros((ctx.rows, grad.shape[1])).index_add_(0, tok, grad), None


class _Combine(torch.autograd.Function):
    """``Σ`` of each pair's ``w · y`` into its token's row; its backward runs inside ``rechub.moe.dispatch.bwd``."""

    @staticmethod
    def forward(ctx, ys, weights, tok, rows: int):
        ctx.save_for_backward(ys, weights, tok)
        return ys.new_zeros((rows, ys.shape[1])).index_add_(0, tok, ys * weights[:, None])

    @staticmethod
    def backward(ctx, grad):
        ys, weights, tok = ctx.saved_tensors
        with annotate("rechub.moe.dispatch.bwd"):
            g = grad[tok]
            return g * weights[:, None], (g * ys).sum(dim=1), None, None


class _Experts(torch.autograd.Function):
    """One gated MLP a held expert over its consecutive rows of ``xs``; the backward, by hand, inside
    ``rechub.moe.experts.bwd``."""

    @staticmethod
    def forward(ctx, xs, counts: List[int], w_gate, w_up, w_down):
        n, width = xs.shape[0], w_gate.shape[1]
        gate, up, ys = xs.new_empty((n, width)), xs.new_empty((n, width)), xs.new_empty((n, w_down.shape[1]))
        start = 0
        for e, c in enumerate(counts):
            if c:
                rows = slice(start, start + c)
                torch.mm(xs[rows], w_gate[e].t(), out=gate[rows])
                torch.mm(xs[rows], w_up[e].t(), out=up[rows])
                torch.mm(F.silu(gate[rows]) * up[rows], w_down[e].t(), out=ys[rows])
            start += c
        ctx.save_for_backward(xs, gate, up, w_gate, w_up, w_down)
        ctx.counts = counts
        return ys

    @staticmethod
    def backward(ctx, grad):
        xs, gate, up, w_gate, w_up, w_down = ctx.saved_tensors
        with annotate("rechub.moe.experts.bwd"):
            dx = torch.empty_like(xs)
            d_gate, d_up, d_down = torch.zeros_like(w_gate), torch.zeros_like(w_up), torch.zeros_like(w_down)
            start = 0
            for e, c in enumerate(ctx.counts):
                if c:
                    rows = slice(start, start + c)
                    g, a, u, x = grad[rows], gate[rows], up[rows], xs[rows]
                    sig = torch.sigmoid(a)
                    act = a * sig
                    torch.mm(g.t(), act * u, out=d_down[e])
                    dh = g @ w_down[e]
                    da = dh * u * (sig * (1 + a * (1 - sig)))
                    du = dh * act
                    torch.mm(da.t(), x, out=d_gate[e])
                    torch.mm(du.t(), x, out=d_up[e])
                    torch.addmm(da @ w_gate[e], du, w_up[e], out=dx[rows])
                start += c
            return dx, None, d_gate, d_up, d_down


class MoE(nn.Module):
    """``DeepseekV2MoE`` over the held experts ``range(first_held, first_held + n_held)`` of ``n_routed`` (module
    docstring); ``forward(x (B, L, d), valid (B, L))``.  ``last_topk`` keeps the last forward's ``(B·L, k)`` expert
    ids, as chosen over all ``n_routed``, and ``last_aux`` its balance loss (None outside training)."""

    graph_safe = False  # the per-expert counts are read on the host

    def __init__(self, d: int, width: int, n_routed: int, n_held: int, first_held: int, top_k: int, n_shared: int, alpha: float, scaling: float = 1.0,
                 std: float = 0.02, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if not (0 <= first_held and first_held + n_held <= n_routed):
            raise ValueError(f"held experts {first_held}..{first_held + n_held - 1} outside the router's {n_routed}")
        self.first_held, self.n_held = first_held, n_held
        self.gate = MoEGate(d, n_routed, top_k, alpha, scaling, generator, device)
        self.experts_gate_proj = nn.Parameter(torch.empty(n_held, width, d, device=device))
        self.experts_up_proj = nn.Parameter(torch.empty(n_held, width, d, device=device))
        self.experts_down_proj = nn.Parameter(torch.empty(n_held, d, width, device=device))
        with torch.no_grad():
            for p in (self.experts_gate_proj, self.experts_up_proj, self.experts_down_proj):
                p.normal_(0.0, std, generator=generator)
        self.shared_experts = GatedMLP(d, width * n_shared, std, generator, device) if n_shared else None
        self.last_topk: Optional[torch.Tensor] = None
        self.last_aux: Optional[torch.Tensor] = None

    def select_pairs(self, ids: torch.Tensor, weights: torch.Tensor, valid: torch.Tensor):
        """``(tokens, weights, counts)`` of the pairs on held experts, sorted by expert: ``counts`` a host list, one
        entry a held expert (the layer's one host read)."""
        k = ids.shape[1]
        local = ids - self.first_held
        held = (local >= 0) & (local < self.n_held) & valid[:, None]
        key = torch.where(held, local, self.n_held).reshape(-1)
        order = torch.argsort(key, stable=True)
        counts = torch.zeros(self.n_held + 1, dtype=torch.int64, device=key.device).scatter_add_(0, key, torch.ones_like(key))[: self.n_held].tolist()
        pick = order[: sum(counts)]
        return torch.div(pick, k, rounding_mode="floor"), weights.reshape(-1)[pick], counts

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        b, l, d = x.shape
        flat, flat_valid = x.reshape(b * l, d), valid.reshape(b * l)
        with annotate("rechub.moe.route"):
            ids, weights, aux = self.gate(flat, flat_valid, b)
            self.last_topk, self.last_aux = ids.detach(), (None if aux is None else aux.detach())
        with annotate("rechub.moe.dispatch"):
            tok, pair_w, counts = self.select_pairs(ids, weights, flat_valid)
            xs = _Gather.apply(flat, tok)
        count("rechub.moe.routed_pairs", sum(counts))
        count("rechub.moe.max_expert_pairs", max(counts, default=0))
        with annotate("rechub.moe.experts"):
            ys = _Experts.apply(xs, counts, self.experts_gate_proj, self.experts_up_proj, self.experts_down_proj)
        with annotate("rechub.moe.dispatch"):
            y = _Combine.apply(ys, pair_w.to(ys.dtype), tok, b * l).view(b, l, d)
        if aux is not None:
            y = AddAuxiliaryLoss.apply(y, aux)
        return y if self.shared_experts is None else y + self.shared_experts(x)
