"""Shared multi-task example plumbing of the PyTorch port (used by run_ali_ccp_multi_task, run_aliexpress,
run_census, run_metabalance, run_gradnorm), as ``examples/ranking/mtl_common.py``."""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from examples_torch.models import build_multitask_model
from torch_rechub_tpu_torch.trainers import MTLTrainer
from torch_rechub_tpu_torch.trainers.base import resolve_device
from torch_rechub_tpu_torch.utils.data import ArrayLoader

MODELS = {"sharedbottom": "SharedBottom", "esmm": "ESMM", "mmoe": "MMOE", "ple": "PLE", "aitm": "AITM"}


def add_mtl_args(parser, default_model="mmoe"):
    parser.add_argument("--model_name", default=default_model, choices=sorted(MODELS))
    parser.add_argument("--adaptive", default=None, choices=[None, "uwl", "gradnorm", "metabalance"])
    parser.add_argument("--epoch", type=int, default=2)
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--seed", type=int, default=2022)
    parser.add_argument("--save_dir", default="./saved")
    parser.add_argument("--dataset_path", default=None, help="real CSV with the reference's column conventions")
    parser.add_argument("--device", default=None, help="default: the card (raises without one); cpu runs on the CPU")
    return parser


def esmm_labels(y):
    """``[cvr, ctr]`` labels as ESMM trains on them: ``[cvr, ctr, ctcvr]``, ctcvr = cvr x ctr."""
    return np.concatenate([y, y[:, :1] * y[:, 1:2]], axis=1)


def fit_multitask(bundle, args):
    """Build model + trainer from a MultiTaskDatasetBundle, fit, return the log."""
    device = resolve_device(args.device)
    name = MODELS[args.model_name]
    model = build_multitask_model(name, bundle, generator=torch.Generator().manual_seed(args.seed), device=device)
    task_types = ("classification",) * 3 if name == "ESMM" else bundle.task_types
    y_train, y_test = bundle.y_train, bundle.y_test
    if name == "ESMM":
        # [cvr, ctr] -> [cvr, ctr, ctcvr]; loss over ctr+ctcvr only (trainer handles it)
        y_train, y_test = esmm_labels(y_train), esmm_labels(y_test)
    adaptive = {"method": args.adaptive} if args.adaptive else None
    trainer = MTLTrainer(model, task_types, adaptive_params=adaptive, optimizer_params={"lr": args.learning_rate}, n_epoch=args.epoch, model_path=args.save_dir, seed=args.seed, device=device)
    log = trainer.fit(
        ArrayLoader(bundle.x_train, y_train, batch_size=args.batch_size, shuffle=True, seed=args.seed),
        ArrayLoader(bundle.x_test, y_test, batch_size=args.batch_size),
    )
    print("final scores:", log[-1])
    return trainer, log
