"""HSTU generative sequence recommendation example, on the PyTorch port.

Usage (as ``examples/generative/run_hstu.py``):
    python examples_torch/generative/run_hstu.py --epoch 3 --d_model 64
Evaluates next-item top-k ranking with seen-item masking (VocabMask parity).
Runs on the card; ``--device cpu`` runs on the CPU.
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from torch_rechub_tpu_torch.models.generative import HSTUModel
from torch_rechub_tpu_torch.trainers import SeqTrainer
from torch_rechub_tpu_torch.trainers.base import resolve_device
from torch_rechub_tpu_torch.utils.data import SequenceDataGenerator
from torch_rechub_tpu_torch.utils.hstu_utils import apply_vocab_mask
from torch_rechub_tpu_torch.utils.match import stable_topk


def synthetic_sequences(n_users=500, vocab=200, seq_len=32, seed=0):
    """Markov-ish item sequences so next-item prediction is learnable."""
    rng = np.random.default_rng(seed)
    trans = rng.integers(1, vocab, (vocab, 3))
    toks = np.zeros((n_users, seq_len), dtype=np.int32)
    tds = np.zeros((n_users, seq_len), dtype=np.int32)
    targets = np.zeros(n_users, dtype=np.int32)
    for u in range(n_users):
        length = rng.integers(seq_len // 2, seq_len + 1)
        cur = rng.integers(1, vocab)
        for t in range(length):
            toks[u, t] = cur
            tds[u, t] = (length - t) * 3600
            cur = trans[cur, rng.integers(0, 3)]
        targets[u] = cur
    return toks, tds, targets


def masked_topk(logits, seen, k):
    """The ids of the ``k`` best items of each row, PAD and the row's seen items masked, ties in id order."""
    masked = apply_vocab_mask(torch.as_tensor(logits), static_invalid=[0], invalid_ids=torch.as_tensor(np.asarray(seen)))
    return stable_topk(masked, k)[1].numpy()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--epoch", type=int, default=3)
    parser.add_argument("--d_model", type=int, default=64)
    parser.add_argument("--n_layers", type=int, default=2)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--vocab", type=int, default=200)
    parser.add_argument("--seq_len", type=int, default=32)
    parser.add_argument("--topk", type=int, default=10)
    parser.add_argument("--save_dir", default="./saved")
    parser.add_argument("--device", default=None, help="default: the card (raises without one); cpu runs on the CPU")
    args = parser.parse_args()
    device = resolve_device(args.device)

    toks, tds, targets = synthetic_sequences(vocab=args.vocab, seq_len=args.seq_len)
    positions = np.tile(np.arange(args.seq_len), (len(toks), 1))
    gen = SequenceDataGenerator(toks, positions, targets, tds)
    train_dl, val_dl, test_dl = gen.generate_dataloader(batch_size=args.batch_size, split_ratio=(0.8, 0.1, 0.1))

    model = HSTUModel(vocab_size=args.vocab, d_model=args.d_model, n_heads=4, n_layers=args.n_layers, dqk=args.d_model // 4, dv=args.d_model // 4, max_seq_len=args.seq_len, dropout=0.1,
                      generator=torch.Generator().manual_seed(0), device=device)
    trainer = SeqTrainer(model, n_epoch=args.epoch, model_path=args.save_dir, device=device)
    trainer.fit(train_dl, val_dl)
    loss, acc = trainer.evaluate(test_dl)
    print(f"test loss {loss:.4f} top1 acc {acc:.4f}")

    # top-k ranking with PAD + seen-item masking
    topk = masked_topk(trainer.predict_logits(test_dl), test_dl.seq_tokens, args.topk)
    hits = np.mean([t in row for t, row in zip(test_dl.targets, topk)])
    print(f"hit@{args.topk} (seen filtered): {hits:.4f}")


if __name__ == "__main__":
    main()
