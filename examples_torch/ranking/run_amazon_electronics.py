"""Amazon-Electronics-style behavior-sequence CTR on the PyTorch port: DIN / DIEN / BST.

As ``examples/ranking/run_amazon_electronics.py``: synthetic Amazon-shaped
click logs through the REAL sequence preprocessing (``generate_seq_feature``:
per-user sliding windows, 1:1 negative sampling, zero-post-padded
histories), then CTRTrainer with target attention.  The preprocessing draws
its negatives and shuffles from a ``random.Random`` seeded with ``--seed``.

    python examples_torch/ranking/run_amazon_electronics.py --model_name din
    python examples_torch/ranking/run_amazon_electronics.py --model_name dien
    python examples_torch/ranking/run_amazon_electronics.py --model_name bst

``--device cpu`` runs it on the CPU.
"""

import argparse
import os
import random
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from torch_rechub_tpu_torch.basic.features import SequenceFeature, SparseFeature
from torch_rechub_tpu_torch.models.ranking import BST, DIEN, DIN
from torch_rechub_tpu_torch.trainers import CTRTrainer
from torch_rechub_tpu_torch.trainers.base import resolve_device
from torch_rechub_tpu_torch.utils.data import DataGenerator, generate_seq_feature, pad_sequences

MODELS = ("din", "dien", "bst")


def make_click_log(n_users=200, n_items=300, n_cates=30, n_clicks=6000, seed=2022):
    """Synthetic (user, item, cate, time) click log with learnable structure."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    users = rng.integers(1, n_users, n_clicks)
    # users gravitate to a per-user item neighborhood → history is predictive
    items = ((users * 13) % n_items + rng.integers(0, 20, n_clicks)).clip(1, n_items - 1)
    cates = items % n_cates + 1
    return pd.DataFrame({"user_id": users, "item_id": items, "cate_id": cates, "time": np.arange(n_clicks)})


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_name", default="din", choices=MODELS)
    parser.add_argument("--epoch", type=int, default=2)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--embed_dim", type=int, default=8)
    parser.add_argument("--max_seq_len", type=int, default=20)
    parser.add_argument("--seed", type=int, default=2022)
    parser.add_argument("--save_dir", default="./saved")
    parser.add_argument("--device", default=None, help="default: the card (raises without one); cpu runs on the CPU")
    args = parser.parse_args()
    device = resolve_device(args.device)

    df = make_click_log(seed=args.seed)
    n_items, n_cates = int(df["item_id"].max()) + 1, int(df["cate_id"].max()) + 1
    train, val, test = generate_seq_feature(df, "user_id", "item_id", "time", item_attribute_cols=["cate_id"], max_len=args.max_seq_len, shuffle=True, rng=random.Random(args.seed))

    def to_x(part):
        x = {
            "target_item_id": np.asarray(part["target_item_id"], np.int32),
            "target_cate_id": np.asarray(part["target_cate_id"], np.int32),
            "hist_item_id": pad_sequences(part["hist_item_id"], maxlen=args.max_seq_len, padding="post").astype(np.int32),
            "hist_cate_id": pad_sequences(part["hist_cate_id"], maxlen=args.max_seq_len, padding="post").astype(np.int32),
            "user_id": np.asarray(part["user_id"], np.int32),
        }
        y = np.asarray(part["label"], np.float32)
        return x, y

    (x_train, y_train), (x_val, y_val), (x_test, y_test) = to_x(train), to_x(val), to_x(test)
    if args.model_name == "dien":
        rng = np.random.default_rng(args.seed)
        for x in (x_train, x_val, x_test):
            hist = x["hist_item_id"]
            neg = np.where(hist > 0, (hist + rng.integers(1, n_items - 1, hist.shape)) % n_items, 0)
            x["neg_hist_item_id"] = np.where((neg == 0) & (hist > 0), 1, neg).astype(np.int32)

    d = args.embed_dim
    profile = (SparseFeature("user_id", vocab_size=int(df["user_id"].max()) + 1, embed_dim=d),)
    target = (
        SparseFeature("target_item_id", vocab_size=n_items, embed_dim=d, padding_idx=0),
        SparseFeature("target_cate_id", vocab_size=n_cates, embed_dim=d, padding_idx=0),
    )
    history = (
        SequenceFeature("hist_item_id", vocab_size=n_items, embed_dim=d, pooling="concat", shared_with="target_item_id", padding_idx=0),
        SequenceFeature("hist_cate_id", vocab_size=n_cates, embed_dim=d, pooling="concat", shared_with="target_cate_id", padding_idx=0),
    )

    where = dict(generator=torch.Generator().manual_seed(args.seed), device=device)
    loss_mode = True
    if args.model_name == "din":
        model = DIN(features=profile, history_features=history, target_features=target, mlp_params={"dims": (64, 32)}, attention_mlp_params={"dims": (36,)}, **where)
    elif args.model_name == "bst":
        model = BST(features=profile, history_features=history, target_features=target, mlp_params={"dims": (64, 32)}, nhead=2, num_layers=1, max_seq_len=args.max_seq_len + 1, dim_feedforward=64, **where)
    else:
        neg_history = (SequenceFeature("neg_hist_item_id", vocab_size=n_items, embed_dim=d, pooling="concat", shared_with="target_item_id", padding_idx=0),)
        model = DIEN(features=profile, history_features=(history[0],), neg_history_features=neg_history, target_features=(target[0],), mlp_params={"dims": (64, 32)}, alpha=0.2, **where)
        loss_mode = False

    train_dl, _, _ = DataGenerator(x_train, y_train).generate_dataloader(batch_size=args.batch_size)
    val_dl, _, _ = DataGenerator(x_val, y_val).generate_dataloader(batch_size=args.batch_size)
    test_dl, _, _ = DataGenerator(x_test, y_test).generate_dataloader(batch_size=args.batch_size)

    trainer = CTRTrainer(model, n_epoch=args.epoch, model_path=args.save_dir, loss_mode=loss_mode, device=device)
    trainer.fit(train_dl, val_dl)
    print("test AUC:", trainer.evaluate(model, test_dl))


if __name__ == "__main__":
    main()
