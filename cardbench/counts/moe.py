"""Model FLOPs of one training step of the ``hllm_moe`` configurations, counted from shapes.

As ``counts/steps.py`` counts: only the products, over the positions that
hold an item (padding does not count), a backward at twice its forward.  A
valid position's forward, in each layer:

- the latent attention's projections: ``q_proj`` (d to H·(n + r)),
  ``kv_a_proj_with_mqa`` (d to c + r), ``kv_b_proj`` (c to H·(n + dv)),
  ``o_proj`` (H·dv to d);
- the attention over its valid (query, key) pairs: ``q·k`` over ``n + r``
  and ``p·v`` over ``dv``, in every head;
- in a dense layer, the gated MLP of width ``intermediate_size`` (three
  products); in an expert layer, the router (d to the router's experts),
  the shared experts (width ``n_shared_experts · moe_intermediate_size``),
  and the held experts at their expected share of the position's ``k``
  picks, ``k · held / router`` pairs of one expert MLP each;
- and once, the sampled softmax: the label's and the shared negatives'
  logits over d.

Elementwise work, norms, softmaxes, the sort and gathers, and the optimizer
do not count.
"""

from __future__ import annotations


def mla_position_flops(cfg: dict) -> float:
    d, h, c = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    n, r, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    return 2 * (d * h * (n + r) + d * (c + r) + c * h * (n + dv) + h * dv * d)


def attention_pair_flops(cfg: dict) -> float:
    return 2 * cfg["num_attention_heads"] * (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"] + cfg["v_head_dim"])


def mlp_flops(d: int, width: int) -> float:
    return 3 * 2 * d * width


def expert_layer_position_flops(cfg: dict) -> float:
    d, w = cfg["hidden_size"], cfg["moe_intermediate_size"]
    router = 2 * d * cfg["n_routed_experts_router"]
    shared = mlp_flops(d, w * cfg["n_shared_experts"])
    held = cfg["num_experts_per_tok"] * cfg["n_routed_experts"] / cfg["n_routed_experts_router"] * mlp_flops(d, w)
    return router + shared + held


def hllm_moe_forward_flops(cfg: dict, tokens: int, pairs: int) -> float:
    """The layers' forward over ``tokens`` valid positions with ``pairs`` valid (query, key) pairs a head."""
    layers = cfg["num_hidden_layers"]
    experts = sum(1 for i in range(layers) if i >= cfg["first_k_dense_replace"] and i % cfg["moe_layer_freq"] == 0)
    attention = layers * (tokens * mla_position_flops(cfg) + pairs * attention_pair_flops(cfg))
    dense = (layers - experts) * tokens * mlp_flops(cfg["hidden_size"], cfg["intermediate_size"])
    return attention + dense + experts * tokens * expert_layer_position_flops(cfg)


def hllm_moe_train_step_flops(cfg: dict, tokens: int, pairs: int) -> float:
    """Forward and backward of the layers and of the sampled softmax (each valid position's label and shared negatives)."""
    sampled = 2 * tokens * cfg["hidden_size"] * (cfg["num_negatives"] + 1)
    return 3 * (hllm_moe_forward_flops(cfg, tokens, pairs) + sampled)
