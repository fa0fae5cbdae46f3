"""TIGER generative retrieval on Amazon-Books-shaped data: RQ-VAE semantic IDs, then trie-constrained seq2seq generation.

The PyTorch port's counterpart of ``examples/generative/run_tiger_amazon_books.py``; ``--device cpu`` runs it on the CPU."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from examples_torch.generative import run_rqvae_tiger


def main():
    presets = "--n_items=500".split()
    for p in presets:
        key = p.split("=")[0]
        if not any(a == key or a.startswith(key + "=") for a in sys.argv[1:]):
            sys.argv.insert(1, p)
    run_rqvae_tiger.main()


if __name__ == "__main__":
    main()
