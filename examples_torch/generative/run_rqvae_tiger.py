"""RQ-VAE -> semantic IDs -> TIGER generative retrieval, end to end, on the PyTorch port.

Usage (as ``examples/generative/run_rqvae_tiger.py``):
    python examples_torch/generative/run_rqvae_tiger.py --rqvae_epochs 10 --tiger_steps 200

TIGER trains in a plain loop, as the JAX example's jitted optax step does:
``torch.optim.AdamW`` at lr 1e-3 and optax's default decay 1e-4, dropout
drawn from a ``torch.Generator`` on the device.  Runs on the card;
``--device cpu`` runs on the CPU.
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from torch_rechub_tpu_torch.models.generative.rqvae import RQVAEModel
from torch_rechub_tpu_torch.models.generative.tiger import TIGERModel, generate
from torch_rechub_tpu_torch.trainers import RQVAETrainer
from torch_rechub_tpu_torch.trainers.base import resolve_device
from torch_rechub_tpu_torch.utils.data import pad_sequences
from torch_rechub_tpu_torch.utils.tiger import Trie, build_tiger_samples, semantic_id_vocab


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--n_items", type=int, default=200)
    parser.add_argument("--emb_dim", type=int, default=32)
    parser.add_argument("--rqvae_epochs", type=int, default=10)
    parser.add_argument("--tiger_steps", type=int, default=200)
    parser.add_argument("--save_dir", default="./saved")
    parser.add_argument("--device", default=None, help="default: the card (raises without one); cpu runs on the CPU")
    args = parser.parse_args()
    device = resolve_device(args.device)

    rng = np.random.default_rng(0)
    # stage 1: item embeddings -> semantic ids
    centers = rng.normal(size=(10, args.emb_dim)) * 3
    item_emb = (centers[rng.integers(0, 10, args.n_items)] + rng.normal(size=(args.n_items, args.emb_dim)) * 0.1).astype(np.float32)
    rqvae = RQVAEModel(in_dim=args.emb_dim, num_emb_list=(32, 32), e_dim=16, layers=(32,), sk_epsilons=(0.0, 0.003), kmeans_init=True, kmeans_iters=5,
                       generator=torch.Generator().manual_seed(0), device=device)
    rq_trainer = RQVAETrainer(rqvae, n_epoch=args.rqvae_epochs, eval_step=5, model_path=args.save_dir, use_sk=False, device=device)
    rq_trainer.fit(item_emb, batch_size=64)
    sids = rq_trainer.generate_semantic_ids(item_emb, batch_size=64)

    vocab, item_tokens = semantic_id_vocab(sids)
    print(f"semantic-id vocab: {len(vocab)} tokens over {len(item_tokens)} items")

    # stage 2: user histories -> TIGER seq2seq over semantic ids
    histories = {u: rng.integers(0, args.n_items, rng.integers(4, 12)).tolist() for u in range(300)}
    tx_in, tx_lab, te_in, te_lab = build_tiger_samples(histories, item_tokens, eos_token_id=1)
    vocab_size = len(vocab) + 2
    max_in = max(len(s) for s in tx_in + te_in)
    X = pad_sequences(tx_in, maxlen=max_in, padding="post")
    Y = pad_sequences(tx_lab, maxlen=3, padding="post", value=-100)
    model = TIGERModel(vocab_size=vocab_size, d_model=64, n_heads=4, n_enc_layers=2, n_dec_layers=2, d_ff=128, dropout=0.1, max_len=max(max_in, 8),
                       generator=torch.Generator().manual_seed(0), device=device)
    optimizer = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)  # optax.adamw(1e-3)'s decay
    dropout = torch.Generator(device=device).manual_seed(1)
    model.train()

    bs = 64
    for it in range(args.tiger_steps):
        idx = rng.integers(0, len(X), bs)
        loss, _ = model(torch.as_tensor(X[idx], device=device), labels=torch.as_tensor(Y[idx], device=device), generator=dropout)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        if (it + 1) % 50 == 0:
            print(f"step {it+1} loss {float(loss.detach()):.4f}")

    # stage 3: trie-constrained generation + recall (skipped for the
    # RQ-VAE-only preset, tiger_steps=0)
    if args.tiger_steps == 0:
        return
    trie = Trie([toks + [1] for toks in item_tokens.values()])
    Xt = pad_sequences(te_in, maxlen=max_in, padding="post")[:50]
    out = generate(model, Xt, max_new_tokens=3, num_beams=5, trie=trie, eos_token_id=1, device=device)
    hits = 0
    for beams, lab in zip(out, te_lab[:50]):
        target = tuple(lab[:-1])
        predicted = [tuple(b[:-1] if b and b[-1] == 1 else b) for b in beams]
        hits += int(target in predicted)
    print(f"recall@5 over semantic ids: {hits/50:.3f}")


if __name__ == "__main__":
    main()
