"""Session-based recommendation example on the PyTorch port: NARM / STAMP / SASRec.

As ``examples/matching/run_sbr.py``: loads the committed
Diginetica sample (``benchmarks/data/diginetica/``), prefix-expands sessions
into next-item samples, trains list-wise (mode=2, full-vocab CE) and reports
NDCG/MRR/Recall/Hit/Precision@top_k on the held-out last-``test_days`` split.

    python examples_torch/matching/run_sbr.py --model_name narm --epoch 2
    python examples_torch/matching/run_sbr.py --model_name stamp --top_k 20
    python examples_torch/matching/run_sbr.py --model_name sasrec        # synthetic sessions

``--device cpu`` runs it on the CPU.
"""

import argparse
import os
import sys
from collections import defaultdict

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from examples_torch.datasets import build_diginetica_session_dataset
from torch_rechub_tpu_torch.basic.features import SequenceFeature, SparseFeature
from torch_rechub_tpu_torch.basic.metric import topk_metrics
from torch_rechub_tpu_torch.models import matching
from torch_rechub_tpu_torch.trainers import MatchTrainer
from torch_rechub_tpu_torch.trainers.base import resolve_device
from torch_rechub_tpu_torch.utils.data import ArrayLoader


def evaluate_next_item(trainer, model, x_test, y_test, batch_size, top_k):
    """Full-vocab top-k over model scores vs held-out next item (reference run_sbr.py:48-64)."""
    scores = trainer.predict(model, ArrayLoader(x_test, batch_size=batch_size))
    rec = np.argsort(-scores, axis=1)[:, :top_k]
    y_true = {i: [int(t)] for i, t in enumerate(y_test)}
    y_pred = {i: list(map(int, r)) for i, r in enumerate(rec)}
    res = defaultdict(float)
    for _, lines in topk_metrics(y_true, y_pred, topKs=[top_k]).items():
        name, value = lines[0].split(":")
        res[name.strip()] = float(value)
    return dict(res)


def run_sasrec(args, device):
    """SASRec on synthetic Markov sessions (dual in-batch-negative API)."""
    rng = np.random.default_rng(0)
    n_items, seq_len = args.n_items, args.max_seq_len
    trans = rng.integers(1, n_items, (n_items, 3))
    seqs = np.zeros((600, seq_len), dtype=np.int32)
    targets = np.zeros(600, dtype=np.int32)
    for i in range(600):
        cur = int(rng.integers(1, n_items))
        for t in range(int(rng.integers(3, seq_len + 1))):
            seqs[i, t] = cur
            cur = int(trans[cur, rng.integers(0, 3)])
        targets[i] = cur
    feats = (SequenceFeature("seq", vocab_size=n_items, embed_dim=args.item_emb_dim, pooling="concat"),)
    item_fea = SparseFeature("target_item", vocab_size=n_items, embed_dim=args.item_emb_dim, shared_with="seq")
    model = matching.SASRec(features=feats, max_len=seq_len, num_blocks=2, item_feature=item_fea, generator=torch.Generator().manual_seed(args.seed), device=device)
    trainer = MatchTrainer(model, mode=0, in_batch_neg=True, in_batch_neg_ratio=16, n_epoch=args.epoch, model_path=args.save_dir, device=device)
    x = {"seq": seqs, "target_item": targets}
    trainer.fit(ArrayLoader(x, np.ones(len(seqs), np.float32), batch_size=args.batch_size, shuffle=True))
    print("SASRec training done (synthetic sessions; retrieval eval via run_ml_matching.py)")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_name", default="narm", choices=["narm", "stamp", "sasrec"])
    parser.add_argument("--data_path", default=None, help="diginetica CSV (default: committed sample)")
    parser.add_argument("--epoch", type=int, default=2)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--item_emb_dim", type=int, default=32)
    parser.add_argument("--hidden_dim", type=int, default=32)
    parser.add_argument("--max_seq_len", type=int, default=19)
    parser.add_argument("--min_item_freq", type=int, default=1, help="reference uses 5 on the full dataset")
    parser.add_argument("--emb_dropout", type=float, default=0.25)
    parser.add_argument("--session_rep_dropout", type=float, default=0.5)
    parser.add_argument("--weight_std", type=float, default=0.05)
    parser.add_argument("--emb_std", type=float, default=0.002)
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--weight_decay", type=float, default=0.0)
    parser.add_argument("--top_k", type=int, default=20)
    parser.add_argument("--n_items", type=int, default=100, help="synthetic sasrec fallback vocab")
    parser.add_argument("--seed", type=int, default=2022)
    parser.add_argument("--save_dir", default="./saved/sbr")
    parser.add_argument("--device", default=None, help="default: the card (raises without one); cpu runs on the CPU")
    args = parser.parse_args()
    device = resolve_device(args.device)

    np.random.seed(args.seed)
    if args.model_name == "sasrec":
        return run_sasrec(args, device)

    bundle = build_diginetica_session_dataset(seed=args.seed, embed_dim=args.item_emb_dim, max_seq_len=args.max_seq_len, min_item_freq=args.min_item_freq, dataset_path=args.data_path)
    print(f"diginetica: {len(bundle.y_train)} train / {len(bundle.y_test)} test samples, {bundle.n_items} items")

    where = dict(generator=torch.Generator().manual_seed(args.seed), device=device)
    if args.model_name == "narm":
        model = matching.NARM(item_history_feature=bundle.item_history_feature, hidden_dim=args.hidden_dim, emb_dropout_p=args.emb_dropout, session_rep_dropout_p=args.session_rep_dropout, **where)
    else:
        model = matching.STAMP(item_history_feature=bundle.item_history_feature, weight_std=args.weight_std, emb_std=args.emb_std, **where)

    trainer = MatchTrainer(model, mode=2, optimizer_params={"lr": args.learning_rate, "weight_decay": args.weight_decay}, n_epoch=args.epoch, model_path=args.save_dir, seed=args.seed, device=device)
    trainer.fit(ArrayLoader(bundle.x_train, bundle.y_train, batch_size=args.batch_size, shuffle=True))

    metrics = evaluate_next_item(trainer, model, bundle.x_test, bundle.y_test, args.batch_size, args.top_k)
    print(f"test metrics: {metrics}")


if __name__ == "__main__":
    main()
