"""The ``hllm_moe`` configurations: the port's ``HLLMModel(backbone="deepseek_v2")`` under ``SeqTrainer``.

The program is built from the configuration, then given the weights the
benchmark made (``weights.make`` over :func:`specs`); the frozen item table
is drawn from the seed apart from them (:func:`item_table`), once for the
program and again for the reference.  The router of each expert layer
scores all ``n_routed_experts_router`` experts; the layer holds
``n_routed_experts`` of them from ``held_experts_first``.

Routing ties: the reference may take the program's choice of experts where
its own ``k``-th and ``k+1``-th logits are within rounding of each other
(``reference/hllm_moe.py``, ``route``).  So :func:`train_step` keeps the
program's choices of the first :data:`KEPT_STEPS` steps after each
:func:`build_trainer`, with the batch they were made on, and
:func:`reference_train` hands each checked batch the choices kept for it
(matched by its item ids).  A choice that differs from the reference's own
away from a near-tie is refused and shows in ``grad_gap`` and ``change_gap``.
"""

from __future__ import annotations

import sys
from typing import Dict, List

import torch

from ..counts import moe as counts
from ..counts.attention import mask_pairs
from ..program import first_grad_norms as program_first_grad_norms
from ..reference import hllm_moe as ref
from ..sampling import generator, sub_seed

KERNELS = {"train": []}  # no kernel of the port's own: the products, attention and dispatch are torch ops
KEPT_STEPS = 4  # at least the traffic's first_steps
MODEL_KEYS = ("hidden_size", "num_attention_heads", "kv_lora_rank", "q_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim", "rms_norm_eps", "rope_theta", "rope_scaling",
              "first_k_dense_replace", "moe_layer_freq", "num_hidden_layers", "intermediate_size", "moe_intermediate_size", "num_experts_per_tok", "n_shared_experts", "aux_loss_alpha",
              "routed_scaling_factor", "norm_topk_prob", "seq_aux", "topk_method", "scoring_func", "initializer_range")
_kept: List[tuple] = []  # (item ids, [each expert layer's (B * L, k) expert ids]) of the steps since the last build
last_ties = {}  # the last reference run's routing ties: {"substituted": n, "refused": n}


def backbone(cfg: dict) -> dict:
    """The model's ``backbone_config``: the block's keys, the router's width and the held share."""
    out = {k: cfg[k] for k in MODEL_KEYS}
    out.update(n_routed_experts=cfg["n_routed_experts_router"], held_experts=[cfg["held_experts_first"], cfg["n_routed_experts"]])
    return out


def moe_layers(cfg: dict) -> List[int]:
    return [i for i in range(cfg["num_hidden_layers"]) if i >= cfg["first_k_dense_replace"] and i % cfg["moe_layer_freq"] == 0]


def specs(cfg: dict):
    """The model's leaves in its names: linear weights and experts N(0, 0.02²), the routers U(±1/sqrt(d)), RMSNorms 1."""
    d, h, std = cfg["hidden_size"], cfg["num_attention_heads"], cfg["initializer_range"]
    n, r, dv, c = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    out, moe = [], set(moe_layers(cfg))
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        out += [
            (p + "input_layernorm.weight", (d,), "const", 1.0),
            (p + "self_attn.q_proj.weight", (h * (n + r), d), "normal", std),
            (p + "self_attn.kv_a_proj_with_mqa.weight", (c + r, d), "normal", std),
            (p + "self_attn.kv_a_layernorm.weight", (c,), "const", 1.0),
            (p + "self_attn.kv_b_proj.weight", (h * (n + dv), c), "normal", std),
            (p + "self_attn.o_proj.weight", (d, h * dv), "normal", std),
            (p + "post_attention_layernorm.weight", (d,), "const", 1.0),
        ]
        if i in moe:
            e, w, s = cfg["n_routed_experts"], cfg["moe_intermediate_size"], cfg["moe_intermediate_size"] * cfg["n_shared_experts"]
            out += [
                (p + "mlp.gate.weight", (cfg["n_routed_experts_router"], d), "uniform", d**-0.5),
                (p + "mlp.experts_gate_proj", (e, w, d), "normal", std), (p + "mlp.experts_up_proj", (e, w, d), "normal", std), (p + "mlp.experts_down_proj", (e, d, w), "normal", std),
                (p + "mlp.shared_experts.gate_proj.weight", (s, d), "normal", std), (p + "mlp.shared_experts.up_proj.weight", (s, d), "normal", std),
                (p + "mlp.shared_experts.down_proj.weight", (d, s), "normal", std),
            ]
        else:
            w = cfg["intermediate_size"]
            out += [(p + "mlp.gate_proj.weight", (w, d), "normal", std), (p + "mlp.up_proj.weight", (w, d), "normal", std), (p + "mlp.down_proj.weight", (d, w), "normal", std)]
    return out + [("norm.weight", (d,), "const", 1.0)]


def item_table(cfg: dict, seed: int, device) -> torch.Tensor:
    """The frozen item LLM's outputs, one N(0, 1) row an item (the model divides each by its norm)."""
    return torch.randn((cfg["vocab_size"], cfg["hidden_size"]), generator=generator(seed, "item_table", device), device=device)


def build_model(cfg: dict, weights: Dict[str, torch.Tensor], seed: int, device):
    from torch_rechub_tpu_torch.models.generative import HLLMModel

    with torch.device(device):  # the constructor's own draws stay on the card; the weights replace them
        model = HLLMModel(item_table(cfg, seed, device), cfg["vocab_size"], d_model=cfg["hidden_size"], max_seq_len=cfg["max_seq_len"], temperature=cfg["temperature"],
                          generator=generator(seed, "constructor", device), device=device, backbone="deepseek_v2", backbone_config=backbone(cfg))
    params = dict(model.named_parameters())
    if set(params) != set(weights) or any(params[n].shape != weights[n].shape for n in params):
        raise RuntimeError(f"the program's leaves differ from the configuration's: {sorted(set(params) ^ set(weights))}")
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(weights[n])
    return model


def build_trainer(cfg: dict, weights, seed: int, device, mesh=None):
    from torch_rechub_tpu_torch.trainers import SeqTrainer

    _kept.clear()
    model = build_model(cfg, weights, seed, device)
    return SeqTrainer(model, optimizer_params={"lr": cfg["lr"], "weight_decay": cfg["weight_decay"]}, loss_type="sampled_softmax",
                      loss_params={"num_negatives": cfg["num_negatives"], "remove_accidental_hits": cfg["remove_accidental_hits"], "logq_correction": cfg["logq_correction"]},
                      seed=trainer_seed(seed), device=device, mesh=mesh)


def trainer_seed(seed: int) -> int:
    """The seed of the trainer's own generator (the sampled negatives): the reference draws them again from it."""
    return sub_seed(seed, "trainer")


def batch(pool: dict, i: int) -> dict:
    j = i % pool["tokens"].shape[0]
    return {k: t[j] for k, t in pool.items()}


def train_step(trainer, b: dict):
    loss = trainer.train_step(b["tokens"], b["times"], b["targets"])
    if len(_kept) < KEPT_STEPS:
        routes = [m.last_topk.clone() for m in trainer.model.modules() if hasattr(m, "last_topk")]
        _kept.append((b["tokens"].clone(), routes))
    return loss


def values(cfg: dict, trainer) -> Dict[str, torch.Tensor]:
    return {n: p.detach() for n, p in trainer.model.named_parameters()}


def first_grad_norms(cfg: dict, trainer) -> Dict[str, float]:
    return program_first_grad_norms(trainer)


def kept_routes(tokens: torch.Tensor):
    """The program's choices kept for the batch with these item ids, or None."""
    return next((routes for ids, routes in _kept if ids.shape == tokens.shape and torch.equal(ids, tokens)), None)


def reference_train(cfg: dict, weights, batches, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(trainer_seed(seed))
    table = ref.normalised_table(item_table(cfg, seed, device))
    model_cfg = {**backbone(cfg), **{k: cfg[k] for k in ("temperature", "num_negatives", "remove_accidental_hits", "logq_correction", "lr", "weight_decay")}}
    out = ref.train(weights, table, batches, model_cfg, gen, [kept_routes(b["tokens"]) for b in batches], allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    del table
    last_ties.update(substituted=out["substituted"], refused=out["refused"])
    print(f"cardbench hllm_moe: routing ties substituted {out['substituted']}, refused {out['refused']} (over {len(batches)} steps)", file=sys.stderr)
    return out


def work(pool: dict) -> list:
    """Each pool batch's rows, valid positions and valid (query, key) pairs of one head."""
    valid = pool["tokens"] != 0
    tokens, pairs = valid.sum(dim=(1, 2)).tolist(), mask_pairs(valid)
    return [{"rows": valid.shape[1], "tokens": t, "pairs": p} for t, p in zip(tokens, pairs)]


def train_flops(cfg: dict, w: dict) -> float:
    return counts.hllm_moe_train_step_flops(cfg, w["tokens"], w["pairs"])
