"""The ``deepfm`` configurations: the port's ``DeepFM`` under ``CTRTrainer`` with its fused sparse tables.

The benchmark makes one table per field (the reference's leaves) and lays
them into the program's tables by the program's layout: a field of at
least ``sparse_min_rows`` rows into the fused table at its offset, any
other into its own table.  The program's readings come back per field the
same way, so both sides are judged leaf by leaf in the reference's names.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ..counts import steps as counts
from ..program import first_grad_norms as program_first_grad_norms
from ..reference import deepfm as ref
from ..sampling import generator

KERNELS = {"train": []}


def specs(cfg: dict):
    """The reference's leaves with the program's initial laws: N(0, 1e-4) tables, torch's fan-in Linear, unit BatchNorms."""
    d = cfg["embed_dim"]
    out = [(f"C{i}", (rows, d), "normal", 1e-4) for i, rows in enumerate(cfg["cardinalities"])]
    flat = len(cfg["cardinalities"]) * d
    out += [("lr.weight", (1, flat), "uniform", 1 / math.sqrt(flat)), ("lr.bias", (1,), "const", 0.0)]
    width = flat + cfg["n_dense"]
    for i, dim in enumerate(cfg["mlp_dims"]):
        out += [(f"mlp.{i}.weight", (dim, width), "uniform", 1 / math.sqrt(width)), (f"mlp.{i}.bias", (dim,), "const", 0.0),
                (f"mlp.{i}.bn_weight", (dim,), "const", 1.0), (f"mlp.{i}.bn_bias", (dim,), "const", 0.0)]
        width = dim
    return out + [("mlp.out.weight", (1, width), "uniform", 1 / math.sqrt(width)), ("mlp.out.bias", (1,), "const", 0.0)]


def dense_names(cfg: dict) -> Dict[str, str]:
    """Reference leaf -> program parameter, for every leaf but the field tables."""
    out = {"lr.weight": "LR_0.Dense_0.weight", "lr.bias": "LR_0.Dense_0.bias"}
    n = len(cfg["mlp_dims"])
    for i in range(n):
        out.update({f"mlp.{i}.weight": f"MLP_0.Dense_{i}.weight", f"mlp.{i}.bias": f"MLP_0.Dense_{i}.bias",
                    f"mlp.{i}.bn_weight": f"MLP_0.BatchNorm_{i}.weight", f"mlp.{i}.bn_bias": f"MLP_0.BatchNorm_{i}.bias"})
    return {**out, "mlp.out.weight": f"MLP_0.Dense_{n}.weight", "mlp.out.bias": f"MLP_0.Dense_{n}.bias"}


def field_tables(cfg: dict, model) -> Dict[str, tuple]:
    """``{field: (program table parameter, first row)}`` by the program's layout; refuses a layout
    whose fused fields are not those of at least ``sparse_min_rows`` rows."""
    ec = model.EmbeddingCollection_0
    fused = {f"C{i}" for i, rows in enumerate(cfg["cardinalities"]) if rows >= cfg["sparse_min_rows"]}
    if set(ec.layout.offsets) != fused:
        raise RuntimeError(f"the program fuses {sorted(ec.layout.offsets)}, the configuration states {sorted(fused)}")
    out = {}
    for i in range(len(cfg["cardinalities"])):
        name = f"C{i}"
        if name in ec.layout.offsets:
            dim, off = ec.layout.offsets[name]
            out[name] = (getattr(ec, f"fused_d{dim}_table"), off)
        else:
            out[name] = (getattr(ec, f"{name}_table"), 0)
    return out


def build_trainer(cfg: dict, weights, seed: int, device, mesh=None):
    from torch_rechub_tpu_torch.basic.features import DenseFeature, SparseFeature
    from torch_rechub_tpu_torch.models.ranking import DeepFM
    from torch_rechub_tpu_torch.ops.embedding import set_fused_default
    from torch_rechub_tpu_torch.trainers import CTRTrainer

    d = cfg["embed_dim"]
    sparse = tuple(SparseFeature(f"C{i}", vocab_size=rows, embed_dim=d) for i, rows in enumerate(cfg["cardinalities"]))
    dense = tuple(DenseFeature(f"I{i}") for i in range(cfg["n_dense"]))
    mlp = {"dims": tuple(cfg["mlp_dims"]), "dropout": cfg["mlp_dropout"], "activation": cfg["mlp_activation"]}
    old = set_fused_default(cfg["table_layout"])
    try:
        with torch.device(device):  # the constructor's own draws stay on the card; the weights replace them
            model = DeepFM(deep_features=sparse + dense, fm_features=sparse, mlp_params=mlp, generator=generator(seed, "constructor", device), device=device)
    finally:
        set_fused_default(old)
    load(cfg, model, weights)
    return CTRTrainer(model, optimizer_params={"lr": cfg["lr"], "weight_decay": cfg["weight_decay"]}, sparse_embedding=cfg["sparse_embedding"], seed=seed, device=device, mesh=mesh)


def load(cfg: dict, model, weights: Dict[str, torch.Tensor]) -> None:
    params = dict(model.named_parameters())
    with torch.no_grad():
        for table, _ in field_tables(cfg, model).values():
            table.zero_()
        for name, (table, off) in field_tables(cfg, model).items():
            table[off: off + weights[name].shape[0]] = weights[name]
        for r, p in dense_names(cfg).items():
            if params[p].shape != weights[r].shape:
                raise RuntimeError(f"{p}: the program's {tuple(params[p].shape)}, the configuration's {tuple(weights[r].shape)}")
            params[p].copy_(weights[r])


def batch(pool: dict, i: int) -> dict:
    j = i % pool["label"].shape[0]
    return {k: t[j] for k, t in pool.items()}


def train_step(trainer, b: dict):
    x = {k: t for k, t in b.items() if k not in ("label", "weight")}
    return trainer.train_step(x, b["label"], b["weight"])



def values(cfg: dict, trainer) -> Dict[str, torch.Tensor]:
    params = dict(trainer.model.named_parameters())
    out = {name: table.detach()[off: off + rows] for (name, (table, off)), rows in zip(field_tables(cfg, trainer.model).items(), cfg["cardinalities"])}
    return {**out, **{r: params[p].detach() for r, p in dense_names(cfg).items()}}


def first_grad_norms(cfg: dict, trainer) -> Dict[str, float]:
    by_program = program_first_grad_norms(trainer)
    params = {id(p): n for n, p in trainer.model.named_parameters()}
    out = {r: by_program.get(p, math.nan) for r, p in dense_names(cfg).items()}  # nan: the optimizer took no step
    accums = {id(trainer.sparse_tables[n]): a for n, a in trainer.sparse_accums.items()}
    for (name, (table, off)), rows in zip(field_tables(cfg, trainer.model).items(), cfg["cardinalities"]):
        if id(table) in accums:  # a row-wise Adagrad table: this field's slice of the accumulator
            out[name] = math.sqrt(table.shape[1] * float(accums[id(table)][off: off + rows].double().sum()))
        else:
            out[name] = by_program.get(params[id(table)], math.nan)
    return out


def reference_train(cfg: dict, weights, batches, seed: int, device) -> dict:
    return ref.train(weights, batches, cfg)


def work(pool: dict) -> list:
    """Each pool batch's rows."""
    return [{"rows": pool["label"].shape[1]}] * pool["label"].shape[0]


def train_flops(cfg: dict, w: dict) -> float:
    return counts.deepfm_example_flops(cfg) * w["rows"]
