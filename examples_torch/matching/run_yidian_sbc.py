"""Yidian-News YoutubeSBC retrieval example on the PyTorch port (as ``examples/matching/run_yidian_sbc.py``).

Covers the reference's YiDian-News showcase (``examples/matching/README.md``
YiDian-News section, data from ``examples/matching/data/yidian_news/``):
two-tower YoutubeSBC over news click logs with in-batch sampled softmax and
word2vec sampling-bias correction served as a ``DenseFeature('sample_weight')``.

    python examples_torch/matching/run_yidian_sbc.py --epoch 2

``--device cpu`` runs it on the CPU.
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from examples_torch.datasets import build_yidian_sbc_dataset
from examples_torch.metrics import evaluate_retrieval
from torch_rechub_tpu_torch.models.matching import YoutubeSBC
from torch_rechub_tpu_torch.trainers import MatchTrainer
from torch_rechub_tpu_torch.trainers.base import resolve_device
from torch_rechub_tpu_torch.utils.data import ArrayLoader


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_path", default=None, help="yidian CSV (default: committed sample)")
    parser.add_argument("--epoch", type=int, default=2)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--embed_dim", type=int, default=16)
    parser.add_argument("--n_neg", type=int, default=3)
    parser.add_argument("--temperature", type=float, default=0.02)
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--top_k", type=int, default=10)
    parser.add_argument("--seed", type=int, default=2022)
    parser.add_argument("--save_dir", default="./saved/yidian_sbc")
    parser.add_argument("--device", default=None, help="default: the card (raises without one); cpu runs on the CPU")
    args = parser.parse_args()
    device = resolve_device(args.device)

    np.random.seed(args.seed)
    bundle = build_yidian_sbc_dataset(seed=args.seed, embed_dim=args.embed_dim, dataset_path=args.data_path)
    print(f"yidian-news: {len(bundle.y_train)} train clicks, {len(bundle.x_all_item['item_id'])} items")

    model = YoutubeSBC(
        user_features=bundle.user_features,
        item_features=bundle.item_features,
        sample_weight_feature=bundle.sample_weight_feature,
        user_params={"dims": (128, 64, args.embed_dim)},
        item_params={"dims": (64, args.embed_dim)},
        batch_size=args.batch_size,
        n_neg=args.n_neg,
        temperature=args.temperature,
        generator=torch.Generator().manual_seed(args.seed),
        device=device,
    )
    trainer = MatchTrainer(model, mode=2, optimizer_params={"lr": args.learning_rate}, n_epoch=args.epoch, model_path=args.save_dir, seed=args.seed, device=device)
    trainer.fit(ArrayLoader(bundle.x_train, bundle.y_train, batch_size=args.batch_size, shuffle=True))

    user_loader = ArrayLoader({k: v for k, v in bundle.x_test_user.items() if not k.startswith("neg")}, batch_size=args.batch_size)
    user_emb = trainer.inference_embedding(model, "user", user_loader, args.save_dir)
    item_emb = trainer.inference_embedding(model, "item", ArrayLoader(bundle.x_all_item, batch_size=args.batch_size), args.save_dir)
    metrics = evaluate_retrieval(user_emb, item_emb, bundle.test_user, bundle.x_all_item, "user_id", "item_id", args.top_k, device=device)
    print(f"test metrics: {metrics}")


if __name__ == "__main__":
    main()
