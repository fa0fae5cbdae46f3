"""DIEN behavior-sequence CTR example on the PyTorch port (as ``examples/ranking/run_dien.py``).

A thin preset over ``run_amazon_electronics.py --model_name dien``: GRU
interest extraction + auxiliary loss + AUGRU evolution.  ``--device cpu``
runs it on the CPU.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from examples_torch.ranking import run_amazon_electronics


def main():
    if not any(a.startswith("--model_name") for a in sys.argv[1:]):
        sys.argv.insert(1, "--model_name=dien")
    run_amazon_electronics.main()


if __name__ == "__main__":
    main()
