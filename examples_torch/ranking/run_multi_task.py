"""Multi-task example on the PyTorch port: 5 MTL models + adaptive methods on census-shaped data.

Usage (as ``examples/ranking/run_multi_task.py``):
    python examples_torch/ranking/run_multi_task.py --model_name mmoe --adaptive gradnorm
``--device cpu`` runs it on the CPU.
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from examples_torch.datasets import build_census_multitask_dataset
from examples_torch.models import build_multitask_model
from examples_torch.ranking.mtl_common import MODELS, esmm_labels
from torch_rechub_tpu_torch.trainers import MTLTrainer
from torch_rechub_tpu_torch.trainers.base import resolve_device
from torch_rechub_tpu_torch.utils.data import ArrayLoader


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_name", default="mmoe", choices=sorted(MODELS))
    parser.add_argument("--adaptive", default=None, choices=[None, "uwl", "gradnorm", "metabalance"])
    parser.add_argument("--epoch", type=int, default=2)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--seed", type=int, default=2022)
    parser.add_argument("--save_dir", default="./saved")
    parser.add_argument("--device", default=None, help="default: the card (raises without one); cpu runs on the CPU")
    args = parser.parse_args()
    device = resolve_device(args.device)

    bundle = build_census_multitask_dataset(seed=args.seed)
    name = MODELS[args.model_name]
    model = build_multitask_model(name, bundle, generator=torch.Generator().manual_seed(args.seed), device=device)
    task_types = ("classification",) * 3 if name == "ESMM" else bundle.task_types
    y_train, y_test = bundle.y_train, bundle.y_test
    if name == "ESMM":
        y_train, y_test = esmm_labels(y_train), esmm_labels(y_test)
    adaptive = {"method": args.adaptive} if args.adaptive else None
    trainer = MTLTrainer(model, task_types, adaptive_params=adaptive, n_epoch=args.epoch, model_path=args.save_dir, seed=args.seed, device=device)
    log = trainer.fit(
        ArrayLoader(bundle.x_train, y_train, batch_size=args.batch_size, shuffle=True),
        ArrayLoader(bundle.x_test, y_test, batch_size=args.batch_size),
    )
    print("final scores:", log[-1])


if __name__ == "__main__":
    main()
