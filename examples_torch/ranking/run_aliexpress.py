"""AliExpress multi-task example (tasks [conversion, click])

The PyTorch port's counterpart of ``examples/ranking/run_aliexpress.py``; ``--device cpu`` runs it on the CPU.

    python examples_torch/ranking/ columns ``categorical_*`` / ``numerical_*``; a real CSV via ``--dataset_path`` or the committed sample.:run_aliexpress.py --model_name ple
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from examples_torch.datasets import build_aliexpress_multitask_dataset
from examples_torch.ranking.mtl_common import add_mtl_args, fit_multitask


def main():
    args = add_mtl_args(argparse.ArgumentParser()).parse_args()
    bundle = build_aliexpress_multitask_dataset(seed=args.seed, dataset_path=args.dataset_path)
    fit_multitask(bundle, args)


if __name__ == "__main__":
    main()
