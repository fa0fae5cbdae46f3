"""Ali-CCP CTR ranking example on the PyTorch port (label = click).

As ``examples/ranking/run_ali_ccp_ctr_ranking.py``: dense columns are the
D*-named ones, everything else (minus click/purchase) is sparse.  A real CSV
via ``--dataset_path`` or the committed schema-identical sample.

    python examples_torch/ranking/run_ali_ccp_ctr_ranking.py --model_name widedeep

``--device cpu`` runs it on the CPU.
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from examples_torch.datasets import build_aliccp_ctr_dataset
from examples_torch.models import build_ranking_model
from torch_rechub_tpu_torch.trainers import CTRTrainer
from torch_rechub_tpu_torch.trainers.base import resolve_device
from torch_rechub_tpu_torch.utils.data import ArrayLoader

MODELS = {"widedeep": "WideDeep", "deepfm": "DeepFM", "dcn": "DCN"}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_name", default="widedeep", choices=sorted(MODELS))
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

    bundle = build_aliccp_ctr_dataset(seed=args.seed, embed_dim=args.embed_dim, dataset_path=args.dataset_path)
    model = build_ranking_model(MODELS[args.model_name], bundle, generator=torch.Generator().manual_seed(args.seed), device=device)
    trainer = CTRTrainer(model, optimizer_params={"lr": args.learning_rate}, n_epoch=args.epoch, model_path=args.save_dir, seed=args.seed, device=device)
    test_dl = ArrayLoader(bundle.x_test, bundle.y_test, batch_size=args.batch_size)
    trainer.fit(ArrayLoader(bundle.x_train, bundle.y_train, batch_size=args.batch_size, shuffle=True, seed=args.seed), test_dl)
    print(f"test auc: {trainer.evaluate(model, test_dl):.4f}")


if __name__ == "__main__":
    main()
