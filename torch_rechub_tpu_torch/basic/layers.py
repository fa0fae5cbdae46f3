"""The layer zoo: the prediction head, LR, MLP with flax-semantics BatchNorm,
FM, CIN, the cross networks (v1, v2, the low-rank mixture), SENet, the
bilinear interaction, AutoInt's interacting layer, FFM and CEN; the
multi-interest layers of the matching models, ``MultiInterestSA`` and
``CapsuleNetwork``.

Counterpart of ``torch_rechub_tpu/basic/layers.py:36-416``.  As there, loops over experts, pairs and fields are
einsums over stacked parameters and index vectors.  flax infers a
``Dense``'s input width at its first call; here every layer takes an
explicit ``in_features``, which the models work out from the feature schema.
Submodules and parameters keep flax's names (``Dense_0``, ``BatchNorm_0``,
``w_{i}``, ``conv_w_{i}``, ``gate_w``, ``W_Q``, ...), so a flax model's
``params`` and ``batch_stats`` load by name (``utils/jax_weights.py``); the
raw parameters are drawn by flax's initializers (``basic/initializers.py``).

Under the bf16 policy (``basic/precision.py``) the ``Dense`` layers and the
parameters the JAX package reads through ``cast_compute`` compute in bf16;
``BatchNorm`` promotes to f32; elsewhere jnp's promotion holds (bf16 with
f32 gives f32).
"""

from __future__ import annotations

from itertools import combinations
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .activation import activation_layer
from .hstu import dropout
from .initializers import linear, param, torch_linear_init, uniform, xavier_normal, zeros
from .precision import cast_compute, promote, sigmoid, softmax, weak
from ..parallel.distributed import data_group, group_size, sum_partitioned


def prediction(x: torch.Tensor, task_type: str = "classification") -> torch.Tensor:
    """Head transform: sigmoid for classification, identity for regression."""
    if task_type not in ("classification", "regression"):
        raise ValueError("task_type must be classification or regression")
    return sigmoid(x) if task_type == "classification" else x


class LR(nn.Module):
    """First-order linear term ``(B, in_features) -> (B, 1)``; optional sigmoid."""

    def __init__(self, in_features: int, sigmoid: bool = False, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.sigmoid = sigmoid
        self.Dense_0 = linear(in_features, 1, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.Dense_0(x)
        return sigmoid(out) if self.sigmoid else out


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis (``use_fast_variance=True``), not ``nn.BatchNorm1d``.

    In training the batch is normalised by its mean and its *biased*
    variance ``E[x²] − E[x]²`` clamped at 0, and the running statistics
    become ``momentum·ra + (1 − momentum)·stat``, the variance biased too
    (``nn.BatchNorm1d`` would store the unbiased one, and eval outputs would
    drift by n/(n−1)).  The statistics are unweighted: every row of the
    batch counts.  The running ``mean`` starts at 0 and ``var`` at 1; in eval
    they normalise.  ``weight`` and ``bias`` are flax's ``scale`` and ``bias``.

    Inside a training step under a device mesh (``parallel.distributed.data_parallel``)
    the statistics are the global batch's, as in the JAX package's global
    program: Σx and Σx² are summed over the data group, whose ranks hold the
    batch's parts, and the running statistics are equal on every rank.
    """

    def __init__(self, num_features: int, momentum: float = 0.9, eps: float = 1e-5, device=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("mean", torch.zeros(num_features, device=device))
        self.register_buffer("var", torch.ones(num_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        if self.training:
            flat = x.reshape(-1, x.shape[-1])
            group = data_group()
            if group is None or group_size(group) == 1:
                mean, mean_sq = flat.mean(0), (flat * flat).mean(0)
            else:  # the global batch's moments: this rank's sums, summed over the data group
                sums = sum_partitioned(torch.stack([flat.sum(0), (flat * flat).sum(0)]), group)
                mean, mean_sq = sums / (flat.shape[0] * group_size(group))
            var = torch.clamp_min(mean_sq - mean * mean, 0.0)
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class MLP(nn.Module):
    """``Dense -> BatchNorm -> activation -> dropout`` per hidden layer, then an optional ``Dense(1)``.

    BatchNorm momentum 0.9 (flax's convention: the weight of the old
    statistics), eps 1e-5.  Dropout draws its masks from the ``generator``
    given to ``forward``.
    """

    def __init__(self, in_features: int, dims: Sequence[int] = (), output_layer: bool = True, dropout: float = 0.0, activation: str = "relu", generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.dims, self.output_layer, self.dropout = tuple(dims), output_layer, dropout
        self.activations = []
        for i, dim in enumerate(self.dims):
            self.add_module(f"Dense_{i}", linear(in_features, dim, generator, device))
            self.add_module(f"BatchNorm_{i}", BatchNorm(dim, device=device))
            act = activation_layer(activation, generator, device)
            if isinstance(act, nn.Module):  # Dice / PReLU hold a parameter: flax names them Dice_i / PReLU_i
                self.add_module(f"{type(act).__name__}_{i}", act)
            self.activations.append(act)
            in_features = dim
        if output_layer:
            self.add_module(f"Dense_{len(self.dims)}", linear(in_features, 1, generator, device))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i, act in enumerate(self.activations):
            x = getattr(self, f"BatchNorm_{i}")(getattr(self, f"Dense_{i}")(x))
            x = dropout(act(x), self.dropout, self.training, generator)
        if self.output_layer:
            x = getattr(self, f"Dense_{len(self.dims)}")(x)
        return x


class FM(nn.Module):
    """Second-order FM interaction ``0.5 * ((Σv)² − Σv²)`` over ``(B, F, D)``."""

    def __init__(self, reduce_sum: bool = True):
        super().__init__()
        self.reduce_sum = reduce_sum

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ix = x.sum(1) ** 2 - (x**2).sum(1)
        if self.reduce_sum:
            ix = ix.sum(1, keepdim=True)
        return 0.5 * ix


def mlp_width(in_features: int, mlp_params) -> int:
    """Output width of an ``MLP(output_layer=False, **mlp_params)`` on ``in_features``."""
    dims = tuple(mlp_params.get("dims", ()))
    return dims[-1] if dims else in_features


def _pair_index(num_fields: int, device=None):
    """The upper-triangle field pairs ``i < j`` in ``combinations`` order, as two index vectors."""
    pairs = list(combinations(range(num_fields), 2))
    return torch.tensor([i for i, _ in pairs], device=device), torch.tensor([j for _, j in pairs], device=device)


class CIN(nn.Module):
    """Compressed Interaction Network (xDeepFM) over ``(B, F0, D)``.

    Layer ``i`` crosses ``x0`` with ``h`` field by field and maps the
    ``F0·Fi`` channels to ``cin_size[i]`` by ``conv_w_{i} (size, F0·Fi)``;
    with ``split_half`` every layer but the last keeps one half for the
    output and feeds the other on.  The pooled channels go through
    ``Dense_0`` to ``(B, 1)``.
    """

    def __init__(self, input_dim: int, cin_size: Sequence[int], split_half: bool = True, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cin_size, self.split_half = tuple(cin_size), split_half
        fi, pooled = input_dim, 0
        for i, size in enumerate(self.cin_size):
            self.register_parameter(f"conv_w_{i}", param(torch_linear_init, (size, input_dim * fi), generator, device))
            self.register_parameter(f"conv_b_{i}", param(zeros, (size,), device=device))
            if split_half and i != len(self.cin_size) - 1:
                if size % 2:
                    raise ValueError(f"cin_size[{i}] = {size} does not split in halves")
                fi = size // 2
            else:
                fi = size
            pooled += fi
        self.Dense_0 = linear(pooled, 1, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, d = x.shape
        x0, h, xs = x, x, []
        for i, size in enumerate(self.cin_size):
            z = (x0[:, :, None, :] * h[:, None, :, :]).reshape(b, -1, d)  # (B, F0·Fi, D)
            w, bias = cast_compute(getattr(self, f"conv_w_{i}")), cast_compute(getattr(self, f"conv_b_{i}"))
            out = F.relu(torch.einsum("bcd,oc->bod", z, w) + bias[None, :, None])
            if self.split_half and i != len(self.cin_size) - 1:
                out, h = torch.split(out, size // 2, dim=1)
            else:
                h = out
            xs.append(out)
        return self.Dense_0(torch.cat(xs, dim=1).sum(2))


class CrossLayer(nn.Module):
    """One DCN cross step ``x0 · (w xi) + b`` over ``(B, d)``."""

    def __init__(self, d: int, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.Dense_0 = linear(d, 1, generator, device, bias=False)
        self.b = param(zeros, (d,), device=device)

    def forward(self, x0: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        return x0 * self.Dense_0(xi) + cast_compute(self.b)


class CrossNetwork(nn.Module):
    """DCN v1 cross network with residual, ``x ← x0 · (w_i x) + b_i + x``."""

    def __init__(self, d: int, num_layers: int, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"w_{i}", linear(d, 1, generator, device, bias=False))
            self.register_parameter(f"b_{i}", param(zeros, (d,), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x0 = x
        for i in range(self.num_layers):
            x = x0 * getattr(self, f"w_{i}")(x) + cast_compute(getattr(self, f"b_{i}")) + x
        return x


class CrossNetV2(nn.Module):
    """DCN v2 full-matrix cross network, ``x ← x0 ⊙ (W_i x) + b_i + x``."""

    def __init__(self, d: int, num_layers: int, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"w_{i}", linear(d, d, generator, device, bias=False))
            self.register_parameter(f"b_{i}", param(zeros, (d,), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x0 = x
        for i in range(self.num_layers):
            x = x0 * getattr(self, f"w_{i}")(x) + cast_compute(getattr(self, f"b_{i}")) + x
        return x


class CrossNetMix(nn.Module):
    """DCN v2's low-rank mixture of experts: per expert ``x0 ⊙ (U tanh(C tanh(Vᵀ x)) + b)``,
    gated by a softmax over the experts (in fp32) of ``gate_w x``.

    ``u_{i}``, ``v_{i}`` are ``(E, d, r)`` and ``c_{i}`` ``(E, r, r)``, all
    experts of a layer in one einsum, as in the JAX package.
    """

    def __init__(self, d: int, num_layers: int = 2, low_rank: int = 32, num_experts: int = 4, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.num_layers = num_layers
        self.gate_w = param(torch_linear_init, (num_experts, d), generator, device)
        for i in range(num_layers):
            for name, shape in (("u", (num_experts, d, low_rank)), ("v", (num_experts, d, low_rank)), ("c", (num_experts, low_rank, low_rank))):
                self.register_parameter(f"{name}_{i}", param(xavier_normal, shape, generator, device))
            self.register_parameter(f"b_{i}", param(zeros, (d,), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x0 = xl = x
        gate_w = cast_compute(self.gate_w)
        for i in range(self.num_layers):
            u, v, c, b = (cast_compute(getattr(self, f"{n}_{i}")) for n in ("u", "v", "c", "b"))
            gate = torch.einsum("bd,ed->be", xl, gate_w)
            vx = torch.tanh(torch.einsum("edr,bd->ber", v, xl))
            cvx = torch.tanh(torch.einsum("ers,bes->ber", c, vx))
            uv = torch.einsum("edr,ber->bed", u, cvx)  # (B, E, d)
            expert_out = x0[:, None, :] * (uv + b)
            xl = torch.einsum("bed,be->bd", expert_out, torch.softmax(gate.to(torch.float32), dim=1).to(expert_out.dtype)) + xl
        return xl


class SENETLayer(nn.Module):
    """Squeeze-excitation field gating (FiBiNet) of ``(B, F, D)``."""

    def __init__(self, num_fields: int, reduction_ratio: int = 3, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        reduced = max(1, num_fields // reduction_ratio)
        self.Dense_0 = linear(num_fields, reduced, generator, device, bias=False)
        self.Dense_1 = linear(reduced, num_fields, generator, device, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = F.relu(self.Dense_1(F.relu(self.Dense_0(x.mean(-1)))))
        return x * a[..., None]


class BiLinearInteractionLayer(nn.Module):
    """Pairwise bilinear field crosses (FiBiNet) of ``(B, F, D)`` into ``(B, F(F-1)/2, D)``.

    ``bilinear_type``: ``"field_all"`` (one ``w (D, D)``), ``"field_each"``
    (``w (F, D, D)``, one per left field) or ``"field_interaction"``
    (``w (P, D, D)``, one per pair).
    """

    def __init__(self, embed_dim: int, num_fields: int, bilinear_type: str = "field_interaction", generator: Optional[torch.Generator] = None, device=None):
        super().__init__()  # the input width first, as torch modules take it; then JAX's parameters in JAX's order
        n_pairs = num_fields * (num_fields - 1) // 2
        shapes = {"field_all": (embed_dim, embed_dim), "field_each": (num_fields, embed_dim, embed_dim), "field_interaction": (n_pairs, embed_dim, embed_dim)}
        if bilinear_type not in shapes:
            raise NotImplementedError(bilinear_type)
        self.bilinear_type = bilinear_type
        self.w = param(torch_linear_init, shapes[bilinear_type], generator, device)
        i_idx, j_idx = _pair_index(num_fields, device)
        self.register_buffer("i_idx", i_idx, persistent=False)
        self.register_buffer("j_idx", j_idx, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = cast_compute(self.w)
        if self.bilinear_type == "field_all":
            return torch.einsum("bfd,de->bfe", x, w)[:, self.i_idx] * x[:, self.j_idx]
        if self.bilinear_type == "field_each":
            return torch.einsum("bfd,fde->bfe", x, w)[:, self.i_idx] * x[:, self.j_idx]
        return torch.einsum("bpd,pde->bpe", x[:, self.i_idx], w) * x[:, self.j_idx]


class InteractingLayer(nn.Module):
    """AutoInt's multi-head self-attention over the fields of ``(B, F, D)``, with a residual ``W_Res`` and ReLU."""

    def __init__(self, embed_dim: int, num_heads: int = 2, dropout: float = 0.0, residual: bool = True, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if embed_dim % num_heads != 0:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.num_heads, self.dropout, self.residual = num_heads, dropout, residual
        for name in ("W_Q", "W_K", "W_V") + (("W_Res",) if residual else ()):
            self.add_module(name, linear(embed_dim, embed_dim, generator, device, bias=False))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, f, d = x.shape
        head_dim = d // self.num_heads
        q, k, v = (m(x).reshape(b, f, self.num_heads, head_dim).transpose(1, 2) for m in (self.W_Q, self.W_K, self.W_V))
        scores = torch.einsum("bhfd,bhgd->bhfg", q, k)
        scores = scores * weak(scores, head_dim**-0.5)
        weights = dropout(torch.softmax(scores.to(torch.float32), dim=-1).to(v.dtype), self.dropout, self.training, generator)
        out = torch.einsum("bhfg,bhgd->bhfd", weights, v).transpose(1, 2).reshape(b, f, d)
        if self.residual:
            out = out + self.W_Res(x)
        return F.relu(out)


class MultiInterestSA(nn.Module):
    """Self-attentive multi-interest extraction (Comirec-SA): ``(B, L, D)`` and a ``(B, L, 1)`` mask to ``(B, K, D)``.

    ``W1 (D, hidden)``, ``W2 (hidden, K)`` drawn from U[0, 1) as flax's
    ``uniform(1.0)``; masked positions take ``-1e9`` before the softmax over L.
    """

    def __init__(self, embedding_dim: int, interest_num: int, hidden_dim: Optional[int] = None, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        hidden = hidden_dim or embedding_dim * 4
        self.W1 = param(uniform(1.0), (embedding_dim, hidden), generator, device)
        self.W2 = param(uniform(1.0), (hidden, interest_num), generator, device)

    def forward(self, seq_emb: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        logits = torch.einsum("bsd,dk->bsk", torch.tanh(torch.einsum("bse,ed->bsd", seq_emb, cast_compute(self.W1))), cast_compute(self.W2))
        if mask is not None:
            logits = logits + -1e9 * (1.0 - mask.to(logits.dtype))
        attn = torch.softmax(logits.to(torch.float32), dim=1).to(seq_emb.dtype)  # over positions
        return torch.einsum("bsk,bsd->bkd", attn, seq_emb)


def _squash(caps: torch.Tensor) -> torch.Tensor:
    """Capsule squash ``|v|²/(1+|v|²) · v/|v|``."""
    norm_sq = (caps * caps).sum(-1, keepdim=True)
    return (norm_sq / (1.0 + norm_sq)) * caps / torch.sqrt(norm_sq + 1e-9)


def routing_start(shape, training: bool, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """MIND's random routing logits: N(0, 1) from ``generator`` in training; at inference a fixed draw
    from a CPU generator seeded 0, where the JAX package draws from ``PRNGKey(0)`` (so the inference draw
    is the same on every device, and different from JAX's)."""
    if training:
        return torch.randn(shape, generator=generator, device=device)
    return torch.randn(shape, generator=torch.Generator().manual_seed(0)).to(device)


class CapsuleNetwork(nn.Module):
    """Dynamic-routing capsule multi-interest extraction (MIND, Comirec-DR): ``(B, L, D)`` and a ``(B, L)``
    mask to ``(B, K, D)``.

    ``bilinear_type`` 0 maps every position by one shared ``Dense_0 (D, D)``
    (MIND), 1 by ``Dense_0 (D, K·D)``, 2 by a per-position weight
    ``w (1, L, K·D, D)`` (Comirec-DR).  Routing runs ``routing_times``
    iterations; every iteration but the last reads the mapped inputs
    detached (flax's ``stop_gradient``), so only the last carries gradients.
    Types 1 and 2 start the routing logits at 0; type 0 at N(0, 1)
    (:func:`routing_start`, or ``routing_weight (B, K, L)`` when given).
    ``relu_layer`` adds ``relu(Dense(D, D))`` on the capsules.
    """

    def __init__(self, embedding_dim: int, seq_len: int, bilinear_type: int = 2, interest_num: int = 4, routing_times: int = 3, relu_layer: bool = False, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        d, k = embedding_dim, interest_num
        self.embedding_dim, self.seq_len, self.bilinear_type = d, seq_len, bilinear_type
        self.interest_num, self.routing_times, self.relu_layer = k, routing_times, relu_layer
        if bilinear_type == 0:
            self.Dense_0 = linear(d, d, generator, device, bias=False)
        elif bilinear_type == 1:
            self.Dense_0 = linear(d, d * k, generator, device, bias=False)
        else:
            self.w = param(uniform(1.0), (1, seq_len, k * d, d), generator, device)
        if relu_layer:  # flax names Dense modules in call order
            self.add_module(f"Dense_{0 if bilinear_type > 1 else 1}", linear(d, d, generator, device, bias=False))

    def forward(self, item_eb: torch.Tensor, mask: torch.Tensor, generator: Optional[torch.Generator] = None, routing_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        b = item_eb.shape[0]
        k, l, d = self.interest_num, self.seq_len, self.embedding_dim
        if self.bilinear_type == 0:
            hat = self.Dense_0(item_eb).repeat(1, 1, k)
        elif self.bilinear_type == 1:
            hat = self.Dense_0(item_eb)
        else:
            hat = torch.einsum("lod,bld->blo", self.w[0, :l], promote(item_eb))
        hat = hat.reshape(b, l, k, d).transpose(1, 2)  # (B, K, L, D)
        hat_iter = hat.detach()
        if self.bilinear_type > 0:
            weight = hat.new_zeros(b, k, l)
        elif routing_weight is not None:
            weight = routing_weight.to(hat.dtype)
        else:
            weight = routing_start((b, k, l), self.training, generator, hat.device).to(hat.dtype)
        masked = (mask.reshape(b, 1, l) == 0).expand(b, k, l)
        capsule = None
        for i in range(self.routing_times):
            soft = softmax(weight, dim=-1).masked_fill(masked, 0.0)
            last = i == self.routing_times - 1
            capsule = _squash(torch.einsum("bkl,bkld->bkd", soft, hat if last else hat_iter))
            if not last:
                weight = weight + torch.einsum("bkld,bkd->bkl", hat_iter, capsule)
        if self.relu_layer:
            capsule = F.relu(getattr(self, f"Dense_{0 if self.bilinear_type > 1 else 1}")(capsule))
        return capsule


class FFM(nn.Module):
    """Field-aware crosses of ``(B, F, F, D)`` embeddings (row: feature, column: the field it faces):
    ``x[:, i, j] ⊙ x[:, j, i]`` for each pair ``i < j``, summed over D with ``reduce_sum``."""

    def __init__(self, num_fields: int, reduce_sum: bool = True, device=None):
        super().__init__()
        self.reduce_sum = reduce_sum
        i_idx, j_idx = _pair_index(num_fields, device)
        self.register_buffer("i_idx", i_idx, persistent=False)
        self.register_buffer("j_idx", j_idx, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        crossed = x[:, self.i_idx, self.j_idx, :] * x[:, self.j_idx, self.i_idx, :]
        return crossed.sum(-1, keepdim=True) if self.reduce_sum else crossed


class CEN(nn.Module):
    """Compose-excitation attention over the field crosses ``(B, P, D)`` (FAT-DeepFFM), flattened to ``(B, P·D)``."""

    def __init__(self, embed_dim: int, num_field_crosses: int, reduction_ratio: int, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.u = param(uniform(1.0), (num_field_crosses, embed_dim), generator, device)
        self.MLP_0 = MLP(num_field_crosses, (num_field_crosses // reduction_ratio, num_field_crosses), output_layer=False, generator=generator, device=device)

    def forward(self, em: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        s = self.MLP_0(F.relu((self.u * em).sum(-1)), generator=generator)
        return (s[..., None] * em).reshape(em.shape[0], -1)
