"""MTLTrainer: multi-task training with adaptive loss weighting.

Counterpart of ``torch_rechub_tpu/trainers/mtl_trainer.py``.  Per-task
losses on the model's probabilities (clipped to ``[1e-7, 1 − 1e-7]``; MSE
for regression), weighted by the padded batch's row weights; aggregated by
the mean, UWL (``Σ 2·L·e^{−w} + w``, ``w = maximum(loss_weight, 0)``),
GradNorm (``Σ L·w``) or, for ESMM, the sum over its ctr and ctcvr tasks.
``loss_weight`` (UWL from 0, GradNorm from 1) is stepped by the same Adam as
the model, weight decay included.

A step is one forward in train mode.  GradNorm takes each task's gradient
of one leaf (the last shared 2-D parameter by sorted flax ``keystr``,
``utils/mtl.py``) from that forward's graph, replaces ``loss_weight``'s
gradient by its closed form and renormalises the weights to sum to
``n_task`` after the step.  MetaBalance takes each task's gradient of every
parameter (no regularization term) and steps the model by the
norm-scaled sum on shared parameters and the plain sum on task ones.  The
JAX package runs one functional forward per task from the same BatchNorm
statistics and dropout key, keeping one statistics update; one forward
here gives the same gradients, one update of the running statistics and
one set of dropout masks.

``sparse_embedding="sgd" | "adagrad"`` updates the fused tables row by row
(``trainers/sparse.py``) under the mean, UWL and ESMM; GradNorm and
MetaBalance need a dense per-task gradient of every shared parameter and
refuse it.  ``steps_per_call`` groups run as single steps.  ``fit``
early-stops on task ``earlystop_taskid``'s validation score, restores the
best weights (the BatchNorm statistics too) and saves
``model_{mode}_{seed}.pt``.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ..basic.callback import EarlyStopper
from ..basic.loss import RegularizationLoss
from ..basic.metric import auc_score
from ..basic.tracking import iter_loggers
from ..models.multi_task import ESMM
from ..ops.sparse_update import record_rows
from ..utils.data import pad_batch
from ..utils.mtl import gradnorm_leaf, gradnorm_weight_grads, metabalance_scale, shared_task_mask
from .base import DictBatchTrainer, resolve_device, to_numpy, under_precision
from .sparse import apply_sparse_table_updates, validate_method


def _aggregate_losses(loss_list: torch.Tensor, loss_weight: Optional[torch.Tensor], method: Optional[str], is_esmm: bool) -> torch.Tensor:
    """The training loss of the ``(n_task,)`` task losses.

    ``torch.maximum`` takes UWL's clamp so that its gradient at the zero
    start is 0.5, as ``jnp.maximum``'s (``clamp_min`` would give 1).
    """
    if is_esmm:
        return loss_list[1:].sum()
    if method == "uwl":
        w = torch.maximum(loss_weight, torch.zeros_like(loss_weight))
        return (2.0 * loss_list * torch.exp(-w) + w).sum()
    if method == "gradnorm":
        return (loss_list * loss_weight).sum()
    return loss_list.mean()


def _task_loss(pred: torch.Tensor, y: torch.Tensor, task_type: str, weight: torch.Tensor) -> torch.Tensor:
    """One task's weighted loss on probabilities (not logits), in fp32.  The clip is ``jnp.clip``'s
    ``minimum(maximum(p, lo), hi)``, whose gradient at a bound is 0.5."""
    pred = pred.to(torch.float32)
    if task_type == "classification":
        lo, hi = (torch.full((), v, dtype=torch.float32, device=pred.device) for v in (1e-7, 1 - 1e-7))  # filled there: no host copy
        p = torch.minimum(torch.maximum(pred, lo), hi)
        loss = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
    else:
        loss = (pred - y) ** 2
    return (loss * weight).sum() / torch.clamp_min(weight.sum(), 1e-12)


class MTLTrainer(DictBatchTrainer):
    """Trains a multi-task model (dict input -> ``(B, n_task)`` probabilities) on ``device``: the CUDA card
    unless the caller passes another (``device="cpu"``); with no card and no device it raises.

    ``precision="bf16"`` computes in bf16 (``basic/precision.py``); the task
    losses and predictions are read in f32.  ``mesh`` is not ported yet and
    raises.
    """

    label_dtype = np.float32

    def __init__(self, model: torch.nn.Module, task_types, optimizer_params=None, regularization_params=None, scheduler_params=None, adaptive_params=None, n_epoch: int = 10, earlystop_taskid: int = 0, earlystop_patience: int = 10, model_path: str = "./", model_logger=None, mesh=None, seed: int = 0, steps_per_call: int = 1, sparse_embedding=None, precision=None, device=None):
        if mesh is not None:
            raise NotImplementedError("MTLTrainer(mesh=...) is not ported yet: the data / model mesh comes with ROADMAP queue 1, item 14")
        self.adaptive_params = adaptive_params or {}
        self.adaptive_method = None
        if adaptive_params is not None:
            method = adaptive_params["method"]
            if method not in ("uwl", "metabalance", "gradnorm"):
                raise ValueError(f"unknown adaptive method {method}")
            self.adaptive_method = method
        if validate_method(sparse_embedding) and self.adaptive_method in ("gradnorm", "metabalance"):
            raise ValueError(
                f"sparse_embedding is incompatible with adaptive method {self.adaptive_method!r}: "
                "per-task gradient surgery needs a dense per-task gradient over every shared "
                "parameter (including the tables). Use mean/uwl aggregation with sparse tables, "
                "or the dense path for gradnorm/metabalance."
            )
        self.task_types = tuple(task_types)
        self.n_task = len(self.task_types)
        device = resolve_device(device)
        start = {"uwl": 0.0, "gradnorm": 1.0}.get(self.adaptive_method)
        self.loss_weight = None if start is None else torch.full((self.n_task,), start, dtype=torch.float32, device=device, requires_grad=True)
        extra = () if self.loss_weight is None else (("loss_weight", self.loss_weight),)
        super().__init__(model, optimizer_params, scheduler_params, n_epoch, earlystop_patience, model_path, seed, model_logger, device, sparse_embedding, extra_params=extra, precision=precision)
        self.steps_per_call = int(steps_per_call)
        self.earlystop_taskid = earlystop_taskid
        self.early_stopper = EarlyStopper(patience=earlystop_patience)
        self.reg_loss_fn = RegularizationLoss(**(regularization_params or {}))
        self.alpha = self.adaptive_params.get("alpha", 0.16)
        self.relax_factor = self.adaptive_params.get("relax_factor", 0.7)
        self.beta = self.adaptive_params.get("beta", 0.9)
        self.is_esmm = isinstance(model, ESMM)
        self.n_steps = 0
        self.initial_task_loss = torch.zeros(self.n_task, dtype=torch.float32, device=self.device)
        named = list(self.model.named_parameters())
        self.gradnorm_leaf = gradnorm_leaf(named) if self.adaptive_method == "gradnorm" else None
        # MetaBalance's split of the parameters and its moving norms, one (n_task,) tensor per parameter (the JAX
        # package keeps them in tree_leaves order)
        self.shared_mask = self.mb_norms = None
        if self.adaptive_method == "metabalance":
            self.shared_mask = shared_task_mask(named)
            self.mb_norms = {n: torch.zeros(self.n_task, dtype=torch.float32, device=self.device) for n, _ in named}

    @property
    def hyperparams(self):
        return {"adaptive_method": self.adaptive_method}

    # -- training ------------------------------------------------------------
    def task_losses(self, out: torch.Tensor, ys: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """The ``(n_task,)`` losses of a batch's ``(B, n_task)`` outputs against its labels."""
        return torch.stack([_task_loss(out[:, i], ys[:, i].to(torch.float32), t, w) for i, t in enumerate(self.task_types)])

    @under_precision
    def train_step(self, x, ys: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """One optimizer step on one padded batch; returns the ``(n_task,)`` losses on the device (no host sync)."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        with record_rows(self.sparse_tables) as rec:
            out = self.model(x, generator=self.generator)
        loss_list = self.task_losses(out, ys, w)
        if self.adaptive_method == "metabalance":
            self._metabalance_grads(loss_list)
        else:
            if self.n_steps == 0:  # set by the first step (the JAX package leaves it at 0 under MetaBalance)
                self.initial_task_loss = loss_list.detach().clone()
            loss = _aggregate_losses(loss_list, self.loss_weight, self.adaptive_method, self.is_esmm)
            if self.reg_loss_fn:  # the sparse tables take none, as in the JAX package
                loss = loss + self.reg_loss_fn((n, p) for n, p in self.model.named_parameters() if n not in self.sparse_tables)
            norms = self._gradnorm_norms(loss_list) if self.adaptive_method == "gradnorm" else None
            loss.backward()
            if norms is not None:
                self.loss_weight.grad = gradnorm_weight_grads(norms, self.loss_weight.detach(), loss_list.detach(), self.initial_task_loss, self.alpha)
        self.optimizer.step()
        apply_sparse_table_updates(self.sparse_tables, self.sparse_accums, rec.records, self.sparse_embedding, self.lr, self.spare_rows)
        if self.adaptive_method == "gradnorm":
            with torch.no_grad():
                self.loss_weight.mul_(self.n_task / torch.clamp_min(self.loss_weight.sum(), 1e-12))
        self.n_steps += 1
        return loss_list.detach()

    def _gradnorm_norms(self, loss_list: torch.Tensor) -> torch.Tensor:
        """``‖d L_i / d leaf‖`` per task, from the step's graph (kept for the backward that follows)."""
        leaf = dict(self.model.named_parameters())[self.gradnorm_leaf]
        norms = []
        for i in range(self.n_task):
            (g,) = torch.autograd.grad(loss_list[i], leaf, retain_graph=True, allow_unused=True)
            norms.append(torch.linalg.vector_norm((torch.zeros_like(leaf) if g is None else g).reshape(-1)))
        return torch.stack(norms)

    def _metabalance_grads(self, loss_list: torch.Tensor) -> None:
        """Set each parameter's ``.grad``: every task's gradient (no regularization), the norm-scaled sum on
        shared parameters, the plain sum on task ones; the moving norms advance."""
        named = list(self.model.named_parameters())
        grads_list = []
        for i in range(self.n_task):
            gs = torch.autograd.grad(loss_list[i], [p for _, p in named], retain_graph=i < self.n_task - 1, allow_unused=True)
            grads_list.append({n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(named, gs)})
        scaled, self.mb_norms = metabalance_scale(grads_list, self.mb_norms, self.relax_factor, self.beta)
        for n, p in named:
            p.grad = scaled[n] if self.shared_mask[n] else sum(g[n] for g in grads_list)

    def train_one_epoch(self, data_loader, lr: Optional[float] = None, log_interval: int = 10) -> List[float]:
        """One pass over ``data_loader``; returns each task's mean step loss (one host read at the end)."""
        self.set_lr(self.lr0 if lr is None else lr)
        losses = []
        n_seen = 0
        t0 = time.perf_counter()
        groups = data_loader.device_groups() if hasattr(data_loader, "device_groups") else self._iter_groups(data_loader)
        for gi, (xs, ys, ws) in enumerate(groups):
            for s in range(ws.shape[0]):  # a group of n batches runs as n single steps
                losses.append(self.train_step({k: v[s] for k, v in xs.items()}, ys[s], ws[s]))
            n_seen += int(ws.shape[0]) * int(ws.shape[1])
            if log_interval and (gi + 1) % log_interval == 0:
                print(f"  train {n_seen} examples, {n_seen / (time.perf_counter() - t0):,.0f} ex/s")
        loss_avg = (to_numpy(torch.stack(losses)).sum(0) / max(len(losses), 1)).tolist() if losses else [0.0] * self.n_task
        print("train loss: ", {f"task_{i}:": loss_avg[i] for i in range(self.n_task)})
        if self.loss_weight is not None:
            print("loss weight: ", to_numpy(self.loss_weight).tolist())
        return loss_avg

    def fit(self, train_dataloader, val_dataloader, mode: str = "base", seed: int = 0):
        """Epochs under StepLR, early stopping on task ``earlystop_taskid``'s validation score (the best
        weights restored), then the checkpoint ``model_{mode}_{seed}.pt``; returns each epoch's scores."""
        for logger in iter_loggers(self.loggers):
            logger.log_hyperparams({"n_epoch": self.n_epoch, "learning_rate": self.lr0, **self.hyperparams})
        total_log = []
        for epoch_i in range(self.n_epoch):
            lr = self.epoch_lr(epoch_i)
            t0 = time.perf_counter()
            train_losses = self.train_one_epoch(train_dataloader, lr=lr)
            print(f"epoch: {epoch_i} ({time.perf_counter() - t0:.2f}s)")
            scores = self.evaluate(self.model, val_dataloader)
            print(f"epoch: {epoch_i} validation scores: {scores}")
            logs = {f"train/task_{i}_loss": train_losses[i] for i in range(self.n_task)}
            logs.update({f"val/task_{i}_score": s for i, s in enumerate(scores)})
            if self.loss_weight is not None:
                logs.update({f"loss_weight/task_{i}": float(w) for i, w in enumerate(to_numpy(self.loss_weight))})
            for logger in iter_loggers(self.loggers):
                logger.log_metrics(logs, step=epoch_i)
            total_log.append(scores)
            # the state_dict holds the BatchNorm running statistics too
            weights = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
            if self.early_stopper.stop_training(scores[self.earlystop_taskid], weights):
                print(f"validation best score of main task {self.earlystop_taskid}: {self.early_stopper.best_auc:.6f}")
                break
        if self.early_stopper.best_weights is not None:
            self.model.load_state_dict(self.early_stopper.best_weights)
        self.save(f"model_{mode}_{seed}.pt")
        for logger in iter_loggers(self.loggers):
            logger.finish()
        return total_log

    # -- evaluation ----------------------------------------------------------
    @torch.inference_mode()
    @under_precision
    def _outputs(self, data_loader):
        """``(fp32 (N, n_task) outputs on the device, labels or None)`` of every real row, the model in eval mode."""
        self.model.eval()
        out, targets = [], []
        for batch in data_loader:
            x, ys = batch if isinstance(batch, tuple) else (batch, None)
            n = len(next(iter(x.values())))
            x, _, _ = pad_batch(x, None, data_loader.batch_size)
            (x,) = self._to_device(x)
            out.append(self.model(x).to(torch.float32)[:n])
            if ys is not None:
                targets.append(np.asarray(ys)[:n])
        return torch.cat(out), (np.concatenate(targets) if targets else None)

    def evaluate(self, model, data_loader) -> List[float]:
        """Each task's validation score: the AUC of a classification task (NaN where its labels hold one
        class), the MSE of a regression task (``model`` is taken for the JAX package's API)."""
        preds, targets = self._outputs(data_loader)
        predicts = to_numpy(preds)
        scores = []
        for i, t in enumerate(self.task_types):
            if t == "classification":
                try:
                    scores.append(auc_score(targets[:, i], predicts[:, i]))
                except ValueError:
                    scores.append(float("nan"))
            else:
                scores.append(float(np.mean((targets[:, i] - predicts[:, i]) ** 2)))
        return scores

    def predict(self, model, data_loader) -> np.ndarray:
        """fp32 ``(N, n_task)`` outputs of every row of ``data_loader`` (one host read at the end)."""
        return to_numpy(self._outputs(data_loader)[0])
