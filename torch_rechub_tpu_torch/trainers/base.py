"""Shared trainer machinery: device, optimizer, learning-rate schedule, checkpoints.

Counterpart of ``torch_rechub_tpu/trainers/base.py``.  The JAX trainers run
one jitted step around ``optax``; here a step is eager PyTorch around
``torch.optim.Adam``, which computes the same update (see
:func:`make_optimizer`).  The learning rate is set per epoch on the
optimizer's parameter groups (:func:`step_lr`).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names another.

    ``None`` means the current CUDA device; with no CUDA device that raises
    rather than quietly running on the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found: pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def make_optimizer(parameters: Iterable[torch.nn.Parameter], optimizer_params: Optional[Dict] = None) -> Tuple[torch.optim.Adam, float]:
    """``(Adam, lr0)``, the update of the JAX package's ``make_optimizer``.

    There, ``add_decayed_weights(wd)`` then ``scale_by_adam(b1)`` with the
    learning rate applied outside: weight decay added to the gradient, then
    bias-corrected Adam with eps 1e-8 outside the square root, which is
    ``torch.optim.Adam(weight_decay=wd)``.  Only ``betas[0]`` is read there,
    so b2 is 0.999 whatever ``betas`` says.
    """
    optimizer_params = dict(optimizer_params or {"lr": 1e-3, "weight_decay": 1e-5})
    lr = float(optimizer_params.pop("lr", 1e-3))
    wd = float(optimizer_params.pop("weight_decay", 0.0))
    b1 = float(optimizer_params.pop("betas", (0.9, 0.999))[0]) if "betas" in optimizer_params else 0.9
    if optimizer_params.pop("embedding_optimizer", None) is not None:
        raise NotImplementedError("embedding_optimizer is not ported yet: it comes with the trainer core of the CTR slice (ROADMAP queue 1, item 7)")
    return torch.optim.Adam(parameters, lr=lr, betas=(b1, 0.999), eps=1e-8, weight_decay=wd), lr


def step_lr(lr0: float, epoch: int, scheduler_params: Optional[Dict]) -> float:
    """StepLR at epoch granularity: ``lr0 * gamma ** (epoch // step_size)``."""
    if not scheduler_params:
        return lr0
    step_size = int(scheduler_params.get("step_size", 1))
    gamma = float(scheduler_params.get("gamma", 0.1))
    return lr0 * gamma ** (epoch // step_size)


class TorchTrainer:
    """What the concrete trainers share: the device, the optimizer, a seeded
    ``torch.Generator`` on the device (dropout masks, sampled negatives),
    the per-epoch learning rate and the ``state_dict`` checkpoint."""

    def __init__(self, model: torch.nn.Module, optimizer_params=None, scheduler_params=None, n_epoch: int = 10, earlystop_patience: int = 10, model_path: str = "./", seed: int = 0, loggers=None, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.optimizer, self.lr0 = make_optimizer(self.model.parameters(), optimizer_params)
        self.scheduler_params = scheduler_params
        self.n_epoch = n_epoch
        self.earlystop_patience = earlystop_patience
        self.model_path = model_path
        self.seed = seed
        self.loggers = loggers
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def epoch_lr(self, epoch: int) -> float:
        return step_lr(self.lr0, epoch, self.scheduler_params)

    def set_lr(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def save(self, name: str = "model.pt") -> str:
        os.makedirs(self.model_path or ".", exist_ok=True)
        target = os.path.join(self.model_path or ".", name)
        torch.save(self.model.state_dict(), target)
        return target

    def load(self, name: str = "model.pt") -> torch.nn.Module:
        target = self.model_path if os.path.isfile(self.model_path) else os.path.join(self.model_path, name)
        self.model.load_state_dict(torch.load(target, map_location=self.device, weights_only=True))
        return self.model
