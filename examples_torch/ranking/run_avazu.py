"""Avazu CTR example on the PyTorch port, the field-aware family (DeepFFM / FAT-DeepFFM) included.

As ``examples/ranking/run_avazu.py``: dense features are min-max scaled AND
discretized into sparse twins; DeepFFM's linear features use 1-dim
embeddings and its cross features declare ``vocab * num_fields`` rows for the
id-offset trick.  A real CSV via ``--dataset_path`` (columns ``f0..f23`` +
``label``) or the committed schema-identical sample.

    python examples_torch/ranking/run_avazu.py --model_name deepffm

``--device cpu`` runs it on the CPU.
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from examples_torch.datasets import build_avazu_ranking_dataset
from examples_torch.models import build_ranking_model
from torch_rechub_tpu_torch.basic.features import SparseFeature
from torch_rechub_tpu_torch.models.ranking import DeepFFM, FatDeepFFM
from torch_rechub_tpu_torch.trainers import CTRTrainer
from torch_rechub_tpu_torch.trainers.base import resolve_device
from torch_rechub_tpu_torch.utils.data import ArrayLoader

MODELS = {"widedeep": "WideDeep", "deepfm": "DeepFM", "dcn": "DCN", "deepffm": None, "fat_deepffm": None}


def build_model(name, bundle, embed_dim, generator=None, device=None):
    where = dict(generator=generator, device=device)
    if name in ("deepffm", "fat_deepffm"):
        sparse = [f for f in bundle.features if isinstance(f, SparseFeature)]
        linear = tuple(SparseFeature(f.name, vocab_size=f.vocab_size, embed_dim=1) for f in sparse)
        cross = tuple(SparseFeature(f.name, vocab_size=f.vocab_size * len(sparse), embed_dim=10) for f in sparse)
        mlp = {"dims": (256, 128), "dropout": 0.2, "activation": "relu"}
        if name == "deepffm":
            return DeepFFM(linear_features=linear, cross_features=cross, embed_dim=10, mlp_params=mlp, **where)
        return FatDeepFFM(linear_features=linear, cross_features=cross, embed_dim=10, reduction_ratio=1, mlp_params=mlp, **where)
    return build_ranking_model(MODELS[name], bundle, **where)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_name", default="deepfm", choices=sorted(MODELS))
    parser.add_argument("--epoch", type=int, default=2)
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--embed_dim", type=int, default=16)
    parser.add_argument("--seed", type=int, default=2022)
    parser.add_argument("--save_dir", default="./saved")
    parser.add_argument("--dataset_path", default=None)
    parser.add_argument("--device", default=None, help="default: the card (raises without one); cpu runs on the CPU")
    args = parser.parse_args()
    device = resolve_device(args.device)

    bundle = build_avazu_ranking_dataset(seed=args.seed, embed_dim=args.embed_dim, dataset_path=args.dataset_path)
    model = build_model(args.model_name, bundle, args.embed_dim, generator=torch.Generator().manual_seed(args.seed), device=device)
    trainer = CTRTrainer(model, optimizer_params={"lr": args.learning_rate}, n_epoch=args.epoch, model_path=args.save_dir, seed=args.seed, device=device)
    trainer.fit(
        ArrayLoader(bundle.x_train, bundle.y_train, batch_size=args.batch_size, shuffle=True, seed=args.seed),
        ArrayLoader(bundle.x_test, bundle.y_test, batch_size=args.batch_size),
    )
    print(f"test auc: {trainer.evaluate(model, ArrayLoader(bundle.x_test, bundle.y_test, batch_size=args.batch_size)):.4f}")


if __name__ == "__main__":
    main()
