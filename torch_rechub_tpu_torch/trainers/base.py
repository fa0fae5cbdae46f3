"""Shared trainer machinery: device, optimizer, learning-rate schedule, checkpoints.

Counterpart of ``torch_rechub_tpu/trainers/base.py``.  The JAX trainers run
one jitted step around ``optax``; here a step is eager PyTorch around
``torch.optim.Adam``, which computes the same update (see
:func:`make_optimizer`).  The learning rate is set per epoch on the
optimizer's parameter groups (:func:`step_lr`).  ``precision=`` (None,
``"f32"``, ``"bf16"``; ``basic/precision.py``) is validated when a trainer is
made, and every forward a trainer runs (the training step, evaluation,
prediction, tower embeddings) runs under it: parameters and optimizer
state stay float32.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..basic.loss import classify_param
from ..basic.precision import _resolve, precision_scope
from ..basic.tracking import iter_loggers
from ..ops.sparse_update import record_rows
from ..utils.data import pad_batch
from .sparse import apply_sparse_table_updates, init_sparse_opt_state, validate_method


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


def under_precision(method):
    """Run a trainer method under the trainer's compute precision (``precision_scope(self.precision)``)."""

    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        with precision_scope(self.precision):
            return method(self, *args, **kwargs)

    return wrapped


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class TableOptimizer(torch.optim.Optimizer):
    """The update of embedding tables under ``embedding_optimizer``, ``p ← p − lr·u``.

    ``"adagrad"`` is optax's ``scale_by_rss(initial_accumulator_value, eps)``:
    ``acc ← acc + g²`` from ``acc = initial_accumulator_value``, then
    ``u = g · rsqrt(acc + eps)`` where ``acc > 0``, else 0.  That is not
    ``torch.optim.Adagrad``, which starts the sum at 0 and adds eps outside
    the square root.  ``"sgd"`` is ``u = g``.  Neither decays weights.
    """

    def __init__(self, params, lr: float, rule: str = "adagrad", initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        if rule not in ("adagrad", "sgd"):
            raise ValueError(f"unknown embedding_optimizer {rule!r}")
        super().__init__(params, dict(lr=lr, rule=rule, initial_accumulator_value=initial_accumulator_value, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["rule"] == "adagrad":
                    state = self.state[p]
                    if not state:
                        state["sum_of_squares"] = torch.full_like(p, group["initial_accumulator_value"])
                    acc = state["sum_of_squares"]
                    acc.add_(g * g)
                    g = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]), 0.0) * g
                p.sub_(group["lr"] * g)


class SplitOptimizer:
    """Adam for the dense parameters and a :class:`TableOptimizer` for the
    embedding tables, stepped, zeroed and scheduled as one optimizer."""

    def __init__(self, *optimizers: torch.optim.Optimizer):
        self.optimizers = optimizers

    @property
    def param_groups(self):
        return [g for opt in self.optimizers for g in opt.param_groups]

    def step(self):
        for opt in self.optimizers:
            opt.step()

    def zero_grad(self, set_to_none: bool = True):
        for opt in self.optimizers:
            opt.zero_grad(set_to_none=set_to_none)


def make_optimizer(parameters: Iterable, optimizer_params: Optional[Dict] = None):
    """``(optimizer, lr0)``, the update of the JAX package's ``make_optimizer``.

    There, ``add_decayed_weights(wd)`` then ``scale_by_adam(b1)`` with the
    learning rate applied outside: weight decay added to the gradient, then
    bias-corrected Adam with eps 1e-8 outside the square root, which is
    ``torch.optim.Adam(weight_decay=wd)``.  Only ``betas[0]`` is read there,
    so b2 is 0.999 whatever ``betas`` says.

    ``embedding_optimizer`` (``"adagrad" | "sgd"``) gives the parameters that
    :func:`classify_param` calls "embedding" a :class:`TableOptimizer` and
    the rest Adam, as optax's ``multi_transform`` does there; it needs
    ``parameters`` as ``(name, parameter)`` pairs (``named_parameters()``).
    """
    optimizer_params = dict(optimizer_params or {"lr": 1e-3, "weight_decay": 1e-5})
    lr = float(optimizer_params.pop("lr", 1e-3))
    wd = float(optimizer_params.pop("weight_decay", 0.0))
    b1 = float(optimizer_params.pop("betas", (0.9, 0.999))[0]) if "betas" in optimizer_params else 0.9
    emb_opt = optimizer_params.pop("embedding_optimizer", None)
    parameters = list(parameters)
    named = bool(parameters) and isinstance(parameters[0], tuple)

    def adam(params):
        return torch.optim.Adam(params, lr=lr, betas=(b1, 0.999), eps=1e-8, weight_decay=wd)

    if emb_opt is None:
        return adam([p for _, p in parameters] if named else parameters), lr
    if emb_opt not in ("adagrad", "sgd"):
        raise ValueError(f"unknown embedding_optimizer {emb_opt!r}")
    if not named:
        raise ValueError("embedding_optimizer sorts parameters by name: pass named_parameters()")
    tables = [p for name, p in parameters if classify_param(name) == "embedding"]
    dense = [p for name, p in parameters if classify_param(name) != "embedding"]
    parts = ([adam(dense)] if dense else []) + ([TableOptimizer(tables, lr, emb_opt)] if tables else [])
    return SplitOptimizer(*parts), lr


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
    the per-epoch learning rate, the training step over the subclass's
    ``loss_fn`` and the ``state_dict`` checkpoint."""

    def __init__(self, model: torch.nn.Module, optimizer_params=None, scheduler_params=None, n_epoch: int = 10, earlystop_patience: int = 10, model_path: str = "./", seed: int = 0, loggers=None, device=None, sparse_embedding=None, sparse_names: Tuple[str, ...] = (), spare_rows: Optional[Dict[str, int]] = None, extra_params: Tuple[Tuple[str, torch.Tensor], ...] = (), precision=None):
        # extra_params: ``(name, tensor)`` pairs outside the model that the dense optimizer steps too
        # (MTLTrainer's loss weights)
        _resolve(precision)  # validated before anything moves
        self.precision = precision
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        # sparse_embedding: the tables the row-wise updates own, their
        # accumulators and fill rows (trainers/sparse.py); the dense optimizer
        # covers the other parameters
        self.sparse_embedding = validate_method(sparse_embedding)
        self.sparse_tables: Dict[str, torch.Tensor] = {}
        self.sparse_accums: Dict[str, torch.Tensor] = {}
        self.spare_rows = dict(spare_rows or {})
        dense = list(self.model.named_parameters())
        if self.sparse_embedding:
            self.sparse_tables, self.sparse_accums, dense = init_sparse_opt_state(self.model, sparse_names)
        self.optimizer, self.lr0 = make_optimizer(dense + list(extra_params), optimizer_params)
        self.lr = self.lr0  # the learning rate of the epoch (set_lr); the sparse table updates read it
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
        self.lr = lr
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    @under_precision
    def train_step(self, *batch) -> torch.Tensor:
        """One optimizer step on one batch (the arguments of ``loss_fn``); returns the loss on the device (no host sync).

        The sparse tables' gather hooks record inside the loss; after the
        dense optimizer, their rows update (``trainers/sparse.py``).  With
        no sparse tables nothing records and nothing more is done.
        """
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        with record_rows(self.sparse_tables) as rec:
            loss = self.loss_fn(*batch)
        loss.backward()
        self.optimizer.step()
        apply_sparse_table_updates(self.sparse_tables, self.sparse_accums, rec.records, self.sparse_embedding, self.lr, self.spare_rows)
        return loss.detach()

    def save(self, name: str = "model.pt") -> str:
        os.makedirs(self.model_path or ".", exist_ok=True)
        target = os.path.join(self.model_path or ".", name)
        torch.save(self.model.state_dict(), target)
        return target

    def load(self, name: str = "model.pt") -> torch.nn.Module:
        target = self.model_path if os.path.isfile(self.model_path) else os.path.join(self.model_path, name)
        state = torch.load(target, map_location=self.device, weights_only=True)
        check_table_rows(state, self.model.state_dict(), target)
        self.model.load_state_dict(state)
        return self.model


class DictBatchTrainer(TorchTrainer):
    """The loop of the trainers whose batches are dicts of arrays (``CTRTrainer``, ``MatchTrainer``): ``loss_fn(x,
    y, w)`` of a padded batch, ``evaluate(model, loader)`` for early stopping, ``hyperparams`` for the loggers.

    Host batches are padded to the loader's ``batch_size`` by cycling their
    rows and weighed 0 there; ``steps_per_call`` of them stack into a group,
    which runs as that many single steps (the JAX package's scan equals it).
    A loader with ``device_groups`` (``DeviceCachedLoader``) hands its groups
    over on the device.  Labels keep their dtype unless ``label_dtype``
    says otherwise.
    """

    label_dtype = None

    @property
    def hyperparams(self) -> Dict:
        return {}

    def _to_device(self, x, *arrays):
        put = lambda a: torch.as_tensor(np.asarray(a), device=self.device)  # noqa: E731
        return ({k: put(v) for k, v in x.items()},) + tuple(put(a) for a in arrays)

    def _iter_groups(self, data_loader):
        """Padded host batches stacked ``steps_per_call`` at a time, as ``(n, batch, ...)`` on the device."""
        batch_size = data_loader.batch_size
        pending = []

        def stacked():
            xs = {k: np.stack([b[0][k] for b in pending]) for k in pending[0][0]}
            ys = np.stack([b[1] for b in pending])
            ws = np.stack([b[2] for b in pending])
            return self._to_device(xs, ys if self.label_dtype is None else ys.astype(self.label_dtype), ws)

        for x, y in data_loader:
            pending.append(pad_batch(x, y, batch_size))
            if len(pending) >= max(1, self.steps_per_call):
                yield stacked()
                pending = []
        if pending:
            yield stacked()

    def train_one_epoch(self, data_loader, log_interval: int = 10, lr: Optional[float] = None) -> float:
        """One pass over ``data_loader``; returns the mean step loss (one host read at the end)."""
        self.set_lr(self.lr0 if lr is None else lr)
        losses = []
        n_seen = 0
        t0 = time.perf_counter()
        groups = data_loader.device_groups() if hasattr(data_loader, "device_groups") else self._iter_groups(data_loader)
        for gi, (xs, ys, ws) in enumerate(groups):
            for s in range(ws.shape[0]):  # a group of n batches runs as n single steps
                losses.append(self.train_step({k: v[s] for k, v in xs.items()}, None if ys is None else ys[s], ws[s]))
            n_seen += int(ws.shape[0]) * int(ws.shape[1])
            if log_interval and (gi + 1) % log_interval == 0:
                print(f"  train {n_seen} examples, loss {float(torch.stack(losses[-ws.shape[0]:]).mean()):.5f}, {n_seen / (time.perf_counter() - t0):,.0f} ex/s")
        return float(to_numpy(torch.stack(losses)).mean()) if losses else 0.0

    def fit(self, train_dataloader, val_dataloader=None, log_interval: int = 10):
        """Epochs under StepLR, early stopping on the validation AUC (the best weights restored), then a checkpoint."""
        for logger in iter_loggers(self.loggers):
            logger.log_hyperparams({"n_epoch": self.n_epoch, "learning_rate": self.lr0, **self.hyperparams})
        for epoch_i in range(self.n_epoch):
            lr = self.epoch_lr(epoch_i)
            t0 = time.perf_counter()
            train_loss = self.train_one_epoch(train_dataloader, log_interval, lr=lr)
            print(f"epoch: {epoch_i} train loss: {train_loss:.5f} ({time.perf_counter() - t0:.2f}s, lr={lr:g})")
            for logger in iter_loggers(self.loggers):
                logger.log_metrics({"train/loss": train_loss, "learning_rate": lr}, step=epoch_i)
            if val_dataloader:
                auc = self.evaluate(self.model, val_dataloader)
                print(f"epoch: {epoch_i} validation auc: {auc:.5f}")
                for logger in iter_loggers(self.loggers):
                    logger.log_metrics({"val/auc": auc}, step=epoch_i)
                # the state_dict holds the BatchNorm running statistics too
                weights = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
                if self.early_stopper.stop_training(auc, weights):
                    print(f"validation: best auc: {self.early_stopper.best_auc}")
                    break
        if val_dataloader and self.early_stopper.best_weights is not None:
            self.model.load_state_dict(self.early_stopper.best_weights)
        self.save()
        for logger in iter_loggers(self.loggers):
            logger.finish()


def check_table_rows(restored: Dict[str, torch.Tensor], template: Dict[str, torch.Tensor], target: str) -> None:
    """Raise a ``ValueError`` naming every embedding table whose ROW count in
    a checkpoint differs from the model's (same width).

    The usual cause: a checkpoint saved before tables of at least 65,536
    rows were padded to a multiple of 64 rows.
    """
    mismatched = {
        k: (tuple(restored[k].shape), tuple(template[k].shape))
        for k in restored.keys() & template.keys()
        if k.endswith(("_table", "_embedding")) and restored[k].shape != template[k].shape and restored[k].shape[1:] == template[k].shape[1:]
    }
    if mismatched:
        detail = ", ".join(f"{k}: checkpoint {c} vs model {t}" for k, (c, t) in sorted(mismatched.items()))
        raise ValueError(
            f"checkpoint {target!r} has embedding tables whose ROW counts differ from the "
            f"model's ({detail}). Tables >= 65536 rows are padded to a 64-row multiple (padded "
            f"rows are zero and take no gradient); a checkpoint saved before that padding cannot "
            f"load directly. Rebuild the model at the checkpoint's shapes, or pad / slice the "
            f"restored table rows to the model's and save again."
        )
