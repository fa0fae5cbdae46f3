"""HSTU on Amazon-Books-shaped sequences: a larger vocab preset; combine with SeqTrainer(vocab_chunk_size=...) for the full 686k-item catalog, or see ``run_hstu_production_vocab.py``.

The PyTorch port's counterpart of ``examples/generative/run_hstu_amazon_books.py``; ``--device cpu`` runs it on the CPU."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from examples_torch.generative import run_hstu


def main():
    presets = "--vocab=2000 --seq_len=64".split()
    for p in presets:
        key = p.split("=")[0]
        if not any(a == key or a.startswith(key + "=") for a in sys.argv[1:]):
            sys.argv.insert(1, p)
    run_hstu.main()


if __name__ == "__main__":
    main()
