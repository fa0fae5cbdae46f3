"""MovieLens sine retrieval example: a thin preset over ``run_ml_matching.py --model_name sine``.

The PyTorch port's counterpart of ``examples/matching/run_ml_sine.py``; ``--device cpu`` runs it on the CPU.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from examples_torch.matching import run_ml_matching


def main():
    if not any(a.startswith("--model_name") for a in sys.argv[1:]):
        sys.argv.insert(1, "--model_name=sine")
    run_ml_matching.main()


if __name__ == "__main__":
    main()
