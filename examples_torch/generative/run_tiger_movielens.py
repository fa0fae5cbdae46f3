"""TIGER generative retrieval on MovieLens-shaped data.

The PyTorch port's counterpart of ``examples/generative/run_tiger_movielens.py``; ``--device cpu`` runs it on the CPU."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from examples_torch.generative import run_rqvae_tiger


def main():
    presets = "--n_items=200".split()
    for p in presets:
        key = p.split("=")[0]
        if not any(a == key or a.startswith(key + "=") for a in sys.argv[1:]):
            sys.argv.insert(1, p)
    run_rqvae_tiger.main()


if __name__ == "__main__":
    main()
