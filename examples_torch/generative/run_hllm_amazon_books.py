"""HLLM on Amazon-Books-shaped sequences: a larger catalog preset with the chunked large-vocab CE.

The PyTorch port's counterpart of ``examples/generative/run_hllm_amazon_books.py``; ``--device cpu`` runs it on the CPU."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from examples_torch.generative import run_hllm


def main():
    presets = "--vocab=2000 --seq_len=32 --vocab_chunk_size=500".split()
    for p in presets:
        key = p.split("=")[0]
        if not any(a == key or a.startswith(key + "=") for a in sys.argv[1:]):
            sys.argv.insert(1, p)
    run_hllm.main()


if __name__ == "__main__":
    main()
