"""Census-income multi-task example (tasks [cvr_label, ctr_label]).

The PyTorch port's counterpart of ``examples/ranking/run_census.py``; ``--device cpu`` runs it on the CPU.

    python examples_torch/ranking/run_census.py --model_name esmm
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from examples_torch.datasets import build_census_multitask_dataset
from examples_torch.ranking.mtl_common import add_mtl_args, fit_multitask


def main():
    args = add_mtl_args(argparse.ArgumentParser()).parse_args()
    bundle = build_census_multitask_dataset(seed=args.seed)
    fit_multitask(bundle, args)


if __name__ == "__main__":
    main()
