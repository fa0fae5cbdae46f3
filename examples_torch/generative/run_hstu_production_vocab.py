"""HSTU at production vocab sizes: sampled softmax + fully sparse tables, on the PyTorch port.

The production recipe for Amazon-Books-scale catalogs (V≈686k, as
``examples/generative/run_hstu_production_vocab.py``) on one card:

- ``tie_embeddings=False``: an untied output projection, required for sparse
  row-wise updates (a tied table takes a dense gradient through the CE).
- ``loss_type="sampled_softmax"``: O(num_negatives) output cost instead of
  O(V); evaluation stays full-vocab exact (chunked automatically).
- ``sparse_embedding="adagrad"``: row-wise updates of BOTH the input token
  table and (under sampled softmax) the output projection: no dense (V, d)
  gradients or Adam moments anywhere.

Every layer's attention runs through the port's CUDA kernels on the card:
the forward K1 (``csrc/hstu_rab_fwd.cu``) and the backward K2
(``csrc/hstu_rab_bwd.cu``), at 4 heads of ``d_model // 4``.

Usage:
    python examples_torch/generative/run_hstu_production_vocab.py --vocab 50000 \\
        --num_negatives 1024 --epoch 3
(defaults are sized to finish quickly; raise --vocab toward the real
catalog size: the training step's cost does not grow with the vocab.)
``--device cpu`` runs it on the CPU.
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from examples_torch.generative.run_hstu import synthetic_sequences

from torch_rechub_tpu_torch.models.generative import HSTUModel
from torch_rechub_tpu_torch.trainers import SeqTrainer
from torch_rechub_tpu_torch.trainers.base import resolve_device
from torch_rechub_tpu_torch.utils.data import SequenceDataGenerator


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--epoch", type=int, default=3)
    parser.add_argument("--d_model", type=int, default=64)
    parser.add_argument("--n_layers", type=int, default=2)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--vocab", type=int, default=50_000)
    parser.add_argument("--seq_len", type=int, default=64)
    parser.add_argument("--num_negatives", type=int, default=1024)
    parser.add_argument("--steps_per_call", type=int, default=8)
    parser.add_argument("--save_dir", default="./saved_production")
    parser.add_argument("--device", default=None, help="default: the card (raises without one); cpu runs on the CPU")
    return parser.parse_args(argv)


def build(args, device, dropout=0.1):
    """The recipe's data loaders (train, val, test), model and trainer, as ``main`` runs them."""
    toks, tds, targets = synthetic_sequences(n_users=1000, vocab=args.vocab, seq_len=args.seq_len)
    positions = np.tile(np.arange(args.seq_len), (len(toks), 1))
    gen = SequenceDataGenerator(toks, positions, targets, tds)
    loaders = gen.generate_dataloader(batch_size=args.batch_size, split_ratio=(0.8, 0.1, 0.1))

    model = HSTUModel(
        vocab_size=args.vocab,
        d_model=args.d_model,
        n_heads=4,
        n_layers=args.n_layers,
        dqk=args.d_model // 4,
        dv=args.d_model // 4,
        max_seq_len=args.seq_len,
        dropout=dropout,
        tie_embeddings=False,  # required for sparse row-wise updates
        generator=torch.Generator().manual_seed(0),
        device=device,
    )
    trainer = SeqTrainer(
        model,
        n_epoch=args.epoch,
        model_path=args.save_dir,
        loss_type="sampled_softmax",
        loss_params={"num_negatives": args.num_negatives},
        sparse_embedding="adagrad",
        steps_per_call=args.steps_per_call,
        device=device,
    )
    return loaders, model, trainer


def main():
    args = parse_args()
    (train_dl, val_dl, test_dl), _, trainer = build(args, resolve_device(args.device))
    trainer.fit(train_dl, val_dl)
    loss, acc = trainer.evaluate(test_dl)  # full-vocab exact eval
    print(f"test loss {loss:.4f} top1 acc {acc:.4f} (vocab={args.vocab}, S={args.num_negatives})")


if __name__ == "__main__":
    main()
