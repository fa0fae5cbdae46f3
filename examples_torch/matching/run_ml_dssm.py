"""MovieLens DSSM retrieval example: a thin alias of ``run_dssm.py`` (two-tower DSSM, in-batch negatives, exact
top-k retrieval eval).

The PyTorch port's counterpart of ``examples/matching/run_ml_dssm.py``; ``--device cpu`` runs it on the CPU.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from examples_torch.matching import run_dssm


def main():
    run_dssm.main()


if __name__ == "__main__":
    main()
