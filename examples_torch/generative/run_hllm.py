"""HLLM generative recommendation on the PyTorch port: frozen LLM item embeddings + transformer.

As ``examples/generative/run_hllm.py``: item embeddings are PRE-COMPUTED
(here synthesized; in production from an LLM encoder), L2-normalized once
and frozen as a buffer; only the transformer trains.  Cosine scoring head
with temperature 0.07.

    python examples_torch/generative/run_hllm.py --epoch 3 --d_model 32

Runs on the card; ``--device cpu`` runs on the CPU.
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from torch_rechub_tpu_torch.models.generative import HLLMModel
from torch_rechub_tpu_torch.trainers import SeqTrainer
from torch_rechub_tpu_torch.trainers.base import resolve_device
from torch_rechub_tpu_torch.utils.data import SequenceDataGenerator


def synthetic_item_embeddings(vocab, d_model, seed=0):
    """Stand-in for LLM-encoded item content: clustered so semantics exist."""
    rng = np.random.default_rng(seed)
    n_clusters = max(4, vocab // 16)
    centers = rng.normal(size=(n_clusters, d_model))
    emb = centers[np.arange(vocab) % n_clusters] + 0.15 * rng.normal(size=(vocab, d_model))
    emb[0] = 0.0  # PAD
    return emb.astype(np.float32)


def synthetic_sequences(n_users, vocab, seq_len, seed=0):
    rng = np.random.default_rng(seed)
    n_clusters = max(4, vocab // 16)
    toks = np.zeros((n_users, seq_len), dtype=np.int32)
    tds = np.zeros((n_users, seq_len), dtype=np.int32)
    targets = np.zeros(n_users, dtype=np.int32)
    for u in range(n_users):
        c = rng.integers(0, n_clusters)  # users stay within a content cluster
        length = rng.integers(seq_len // 2, seq_len + 1)
        choices = np.arange(1, vocab)[(np.arange(1, vocab) % n_clusters) == c]
        seq = rng.choice(choices, size=length + 1)
        toks[u, seq_len - length:] = seq[:-1]
        tds[u, seq_len - length:] = np.arange(length)[::-1] * 3600
        targets[u] = seq[-1]
    return toks, tds, targets


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--epoch", type=int, default=3)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--d_model", type=int, default=32)
    parser.add_argument("--n_users", type=int, default=400)
    parser.add_argument("--vocab", type=int, default=128)
    parser.add_argument("--seq_len", type=int, default=24)
    parser.add_argument("--vocab_chunk_size", type=int, default=None, help="chunked CE for large vocabs")
    parser.add_argument("--embeddings_path", default=None, help=".npy of (vocab, d_model) LLM item embeddings")
    parser.add_argument("--save_dir", default="./saved")
    parser.add_argument("--device", default=None, help="default: the card (raises without one); cpu runs on the CPU")
    args = parser.parse_args()
    device = resolve_device(args.device)

    if args.embeddings_path:
        item_emb = np.load(args.embeddings_path).astype(np.float32)
        vocab, d_model = item_emb.shape
    else:
        vocab, d_model = args.vocab, args.d_model
        item_emb = synthetic_item_embeddings(vocab, d_model)

    toks, tds, targets = synthetic_sequences(args.n_users, vocab, args.seq_len)
    positions = np.tile(np.arange(args.seq_len, dtype=np.int32), (args.n_users, 1))
    gen = SequenceDataGenerator(toks, positions, targets, tds)
    train_dl, val_dl, test_dl = gen.generate_dataloader(batch_size=args.batch_size, split_ratio=(0.8, 0.1, 0.1))

    model = HLLMModel(item_embeddings=item_emb, vocab_size=vocab, d_model=d_model, n_heads=2, n_layers=2, max_seq_len=args.seq_len, dropout=0.1,
                      generator=torch.Generator().manual_seed(0), device=device)
    trainer = SeqTrainer(model, n_epoch=args.epoch, model_path=args.save_dir, vocab_chunk_size=args.vocab_chunk_size, device=device)
    trainer.fit(train_dl, val_dl)
    loss, hit = trainer.evaluate(test_dl)
    print(f"test loss: {loss:.4f}  top-1 hit: {hit:.4f}")


if __name__ == "__main__":
    main()
