"""Criteo CTR example on the PyTorch port: any ranking model, on the committed sample or a synthetic one.

Usage (as ``examples/ranking/run_criteo.py``):
    python examples_torch/ranking/run_criteo.py --model_name deepfm --epoch 2
``--device cpu`` runs it on the CPU.
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from examples_torch.datasets import build_criteo_ranking_dataset
from examples_torch.models import build_ranking_model
from torch_rechub_tpu_torch.trainers import CTRTrainer
from torch_rechub_tpu_torch.trainers.base import resolve_device
from torch_rechub_tpu_torch.utils.data import ArrayLoader

MODELS = {"widedeep": "WideDeep", "deepfm": "DeepFM", "dcn": "DCN", "dcn_v2": "DCNv2", "edcn": "EDCN", "afm": "AFM", "autoint": "AutoInt", "fibinet": "FiBiNet"}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_name", default="deepfm", choices=sorted(MODELS))
    parser.add_argument("--epoch", type=int, default=2)
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--weight_decay", type=float, default=1e-5)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--embed_dim", type=int, default=16)
    parser.add_argument("--seed", type=int, default=2022)
    parser.add_argument("--save_dir", default="./saved")
    parser.add_argument("--device", default=None, help="default: the card (raises without one); cpu runs on the CPU")
    args = parser.parse_args()
    device = resolve_device(args.device)

    bundle = build_criteo_ranking_dataset(seed=args.seed, embed_dim=args.embed_dim)
    model = build_ranking_model(MODELS[args.model_name], bundle, generator=torch.Generator().manual_seed(args.seed), device=device)
    trainer = CTRTrainer(
        model,
        optimizer_params={"lr": args.learning_rate, "weight_decay": args.weight_decay},
        n_epoch=args.epoch,
        model_path=args.save_dir,
        seed=args.seed,
        device=device,
    )
    train_dl = ArrayLoader(bundle.x_train, bundle.y_train, batch_size=args.batch_size, shuffle=True, seed=args.seed)
    test_dl = ArrayLoader(bundle.x_test, bundle.y_test, batch_size=args.batch_size)
    trainer.fit(train_dl, test_dl)
    auc = trainer.evaluate(model, test_dl)
    print(f"test auc: {auc:.4f}")


if __name__ == "__main__":
    main()
