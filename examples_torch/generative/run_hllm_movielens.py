"""HLLM on MovieLens-shaped sequences: the frozen LLM item embeddings preset; pass --embeddings_path for real precomputed embeddings.

The PyTorch port's counterpart of ``examples/generative/run_hllm_movielens.py``; ``--device cpu`` runs it on the CPU."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from examples_torch.generative import run_hllm


def main():
    presets = "--vocab=400 --seq_len=32".split()
    for p in presets:
        key = p.split("=")[0]
        if not any(a == key or a.startswith(key + "=") for a in sys.argv[1:]):
            sys.argv.insert(1, p)
    run_hllm.main()


if __name__ == "__main__":
    main()
