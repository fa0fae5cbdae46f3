"""Two-tower retrieval example on the PyTorch port: DSSM with in-batch negatives -> exact top-k eval.

Usage (as ``examples/matching/run_dssm.py``):
    python examples_torch/matching/run_dssm.py --epoch 4 --in_batch_neg
``--device cpu`` runs it on the CPU.
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from examples_torch.datasets import build_ml1m_matching_dataset
from torch_rechub_tpu_torch.models.matching import DSSM
from torch_rechub_tpu_torch.serving import match_evaluation
from torch_rechub_tpu_torch.trainers import MatchTrainer
from torch_rechub_tpu_torch.trainers.base import resolve_device
from torch_rechub_tpu_torch.utils.data import ArrayLoader


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--epoch", type=int, default=4)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--embed_dim", type=int, default=16)
    parser.add_argument("--in_batch_neg", action="store_true")
    parser.add_argument("--topk", type=int, default=10)
    parser.add_argument("--save_dir", default="./saved")
    parser.add_argument("--device", default=None, help="default: the card (raises without one); cpu runs on the CPU")
    args = parser.parse_args()
    device = resolve_device(args.device)

    mode = 0
    bundle = build_ml1m_matching_dataset(embed_dim=args.embed_dim, mode=mode, neg_ratio=3)
    model = DSSM(
        user_features=bundle.user_features,
        item_features=bundle.item_features,
        user_params={"dims": (64, args.embed_dim)},
        item_params={"dims": (64, args.embed_dim)},
        generator=torch.Generator().manual_seed(0),
        device=device,
    )
    trainer = MatchTrainer(model, mode=mode, in_batch_neg=args.in_batch_neg, in_batch_neg_ratio=16, n_epoch=args.epoch, model_path=args.save_dir, device=device)
    x_train, y_train = bundle.x_train, bundle.y_train
    if args.in_batch_neg:
        keep = y_train == 1
        x_train = {k: v[keep] for k, v in x_train.items()}
        y_train = y_train[keep]
    trainer.fit(ArrayLoader(x_train, y_train, batch_size=args.batch_size, shuffle=True))

    test_x = {k: v for k, v in bundle.x_test_user.items() if not k.startswith("neg")}
    user_emb = trainer.inference_embedding(model, "user", ArrayLoader(test_x, batch_size=args.batch_size), args.save_dir)
    item_emb = trainer.inference_embedding(model, "item", ArrayLoader(bundle.x_all_item, batch_size=args.batch_size), args.save_dir)
    match_evaluation(user_emb, item_emb, bundle.test_user, bundle.x_all_item, user_col="user_id", item_col="movie_id", topk=args.topk, device=device)


if __name__ == "__main__":
    main()
