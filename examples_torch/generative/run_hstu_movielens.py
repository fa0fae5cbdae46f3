"""HSTU on MovieLens-shaped sequences: a preset over ``run_hstu.py`` with an ML-1M-like vocab and sequence length.

The PyTorch port's counterpart of ``examples/generative/run_hstu_movielens.py``; ``--device cpu`` runs it on the CPU."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from examples_torch.generative import run_hstu


def main():
    presets = "--vocab=400 --seq_len=64".split()
    for p in presets:
        key = p.split("=")[0]
        if not any(a == key or a.startswith(key + "=") for a in sys.argv[1:]):
            sys.argv.insert(1, p)
    run_hstu.main()


if __name__ == "__main__":
    main()
