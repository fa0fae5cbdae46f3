"""The ``hstu`` configurations: the port's ``HSTUModel`` under ``SeqTrainer``, and its served retrieval path.

The program is built from the configuration, then given the weights the
benchmark made (``weights.make`` over :func:`specs`), so the reference
starts from the same numbers without reading any of the program's.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ..counts import steps as counts
from ..counts.attention import mask_pairs
from ..reference import hstu as ref
from ..program import first_grad_norms as program_first_grad_norms
from ..reference.topk import scores_of, topk
from ..sampling import generator, sub_seed

KERNELS = {"train": ["hstu_rab_fwd", "hstu_rab_bwd"], "serve": ["hstu_rab_fwd"]}


def xavier(rows: int, cols: int) -> float:
    return math.sqrt(6.0 / (rows + cols))


def specs(cfg: dict):
    """The leaves in the model's names, with its initial laws (Glorot tables, torch's fan-in Linear, unit LayerNorms)."""
    v, d, n, nb = cfg["vocab_size"], cfg["d_model"], cfg["max_seq_len"], cfg["num_time_buckets"]
    h, dqk, dv = cfg["n_heads"], cfg["dqk"], cfg["dv"]
    out = [("token_embedding", (v, d), "uniform_pad0", xavier(v, d)), ("position_embedding", (n, d), "uniform", xavier(n, d))]
    if cfg["use_time_embedding"]:
        out.append(("time_embedding", (nb, d), "uniform", xavier(nb, d)))
    width = 2 * h * dqk + 2 * h * dv
    for i in range(cfg["n_layers"]):
        p = f"hstu_block.layers.{i}."
        out += [
            (p + "norm_in.weight", (d,), "const", 1.0), (p + "norm_in.bias", (d,), "const", 0.0),
            (p + "proj1.weight", (width, d), "uniform", 1 / math.sqrt(d)), (p + "proj1.bias", (width,), "const", 0.0),
            (p + "rab.pos_w", (2 * n - 1, h), "uniform", math.sqrt(1 / (2 * n - 1))), (p + "rab.ts_w", (nb + 1, h), "uniform", math.sqrt(1 / (nb + 1))),
            (p + "norm_attn.weight", (h * dv,), "const", 1.0), (p + "norm_attn.bias", (h * dv,), "const", 0.0),
            (p + "proj2.weight", (d, h * dv), "uniform", 1 / math.sqrt(h * dv)), (p + "proj2.bias", (d,), "const", 0.0),
        ]
    return out + [("output_projection", (v, d), "uniform", xavier(v, d))]


def build_model(cfg: dict, weights: Dict[str, torch.Tensor], seed: int, device):
    from torch_rechub_tpu_torch.models.generative import HSTUModel

    with torch.device(device):  # the constructor's own draws stay on the card; the weights replace them
        model = HSTUModel(
            vocab_size=cfg["vocab_size"], d_model=cfg["d_model"], n_heads=cfg["n_heads"], n_layers=cfg["n_layers"], dqk=cfg["dqk"], dv=cfg["dv"],
            max_seq_len=cfg["max_seq_len"], dropout=cfg["dropout"], use_time_embedding=cfg["use_time_embedding"], num_time_buckets=cfg["num_time_buckets"],
            time_bucket_fn=cfg["time_bucket_fn"], time_bucket_divisor=cfg["time_bucket_divisor"], time_bucket_unit=cfg["time_bucket_unit"],
            tie_embeddings=cfg["tie_embeddings"], score_norm=cfg["score_norm"], temperature=cfg["temperature"], use_output_bias=cfg["use_output_bias"],
            scale_input_embedding=cfg["scale_input_embedding"], l2_norm_eps=cfg["l2_norm_eps"], generator=generator(seed, "constructor", device), device=device,
        )
    load(model, weights)
    return model


def load(model, weights: Dict[str, torch.Tensor]) -> None:
    params = dict(model.named_parameters())
    if set(params) != set(weights) or any(params[n].shape != weights[n].shape for n in params):
        raise RuntimeError(f"the program's leaves differ from the configuration's: {sorted(set(params) ^ set(weights))}")
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(weights[n])


def build_trainer(cfg: dict, weights, seed: int, device, mesh=None):
    from torch_rechub_tpu_torch.trainers import SeqTrainer

    model = build_model(cfg, weights, seed, device)
    return SeqTrainer(
        model, optimizer_params={"lr": cfg["lr"], "weight_decay": cfg["weight_decay"]}, loss_type=cfg["loss_type"],
        loss_params={"num_negatives": cfg["num_negatives"], "remove_accidental_hits": cfg["remove_accidental_hits"], "logq_correction": cfg["logq_correction"]},
        sparse_embedding=cfg["sparse_embedding"], seed=trainer_seed(seed), device=device, mesh=mesh,
    )


def trainer_seed(seed: int) -> int:
    """The seed of the trainer's own generator (the sampled negatives): the reference draws them again from it."""
    return sub_seed(seed, "trainer")


def batch(pool: dict, i: int) -> dict:
    j = i % pool["tokens"].shape[0]
    return {k: t[j] for k, t in pool.items()}


def train_step(trainer, b: dict):
    return trainer.train_step(b["tokens"], b["times"], b["targets"])



def values(cfg: dict, trainer) -> Dict[str, torch.Tensor]:
    return {n: p.detach() for n, p in trainer.model.named_parameters()}


def first_grad_norms(cfg: dict, trainer) -> Dict[str, float]:
    return program_first_grad_norms(trainer)


def reference_train(cfg: dict, weights, batches, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(trainer_seed(seed))
    return ref.train(weights, batches, cfg, gen)


def serve(model, b: dict, k: int):
    """One request: the histories' last hidden states, then the exact top-k over every item; ``(ids, scores)`` on the host."""
    from torch_rechub_tpu_torch.serving.retrieval import brute_force_topk

    with torch.inference_mode():
        out = model(b["tokens"], b["times"], return_hidden=True)
        with torch.profiler.record_function("cardbench.retrieval"):
            return brute_force_topk(out["hidden"][:, -1, :], out["weight"], k, device=b["tokens"].device)


def reference_serve(cfg: dict, weights, b: dict, served_ids: torch.Tensor, k: int) -> dict:
    with torch.no_grad():
        hidden, items = ref.user_and_items(weights, b["tokens"], b["times"], cfg)
        best, _ = topk(hidden, items, k)
        if served_ids.shape != best.shape:  # users or items missing: nothing to score, the judge fails it
            return {"best": best, "of_served": torch.full_like(best, -torch.inf)}
        return {"best": best, "of_served": scores_of(hidden, items, served_ids)}


def reference_answer(cfg: dict, weights, b: dict, k: int):
    """The reference put in the serving path's place: ``(ids, scores)`` of its own top-k (the control, run in TF32)."""
    with torch.no_grad():
        hidden, items = ref.user_and_items(weights, b["tokens"], b["times"], cfg)
        scores, ids = topk(hidden, items, k)
        return ids, scores


def work(pool: dict) -> list:
    """Each pool batch's rows, valid positions and valid (query, key) pairs of one head."""
    valid = pool["tokens"] != 0
    tokens, pairs = valid.sum(dim=(1, 2)).tolist(), mask_pairs(valid)
    return [{"rows": valid.shape[1], "tokens": t, "pairs": p} for t, p in zip(tokens, pairs)]


def train_flops(cfg: dict, w: dict) -> float:
    return counts.hstu_train_step_flops(cfg, w["tokens"], w["pairs"])


def serve_flops(cfg: dict, w: dict) -> float:
    return counts.hstu_serve_request_flops(cfg, w["rows"], w["tokens"], w["pairs"])
