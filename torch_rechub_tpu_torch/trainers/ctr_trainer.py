"""CTRTrainer: single-task binary CTR training, evaluation and prediction.

Counterpart of ``torch_rechub_tpu/trainers/ctr_trainer.py``.  A step is
eager PyTorch: the model's logits in train mode, BCE with logits weighted
by the padded batch's row weights (plus the regularization and, with
``loss_mode=False``, the model's auxiliary loss), ``backward``, the
optimizer.  Every batch is padded to the loader's ``batch_size`` by cycling
its rows, so BatchNorm sees the same batch as in the JAX package.
``steps_per_call`` groups run as that many single steps, which the JAX
package's scan equals.  Host batches reach the card through
``prefetch_to_device`` two groups ahead (``data/dataset.py``), and after
each group the loop takes a step checkpoint where
``enable_step_checkpointing`` asked for one (``trainers/base.py``).
``fit`` runs epochs with StepLR and early stopping on the validation AUC;
``predict`` returns fp32 probabilities of the real rows; ``evaluate`` the
exact AUC, or the bucketed one from histograms that add up on the device.

``sparse_embedding="sgd" | "adagrad"`` updates the fused tables row by row
(``trainers/sparse.py``): Adam (and the regularization) cover the other
parameters only, the per-feature tables included.

``mesh=`` trains over a (data, model) mesh of ranks (``trainers/base.py``,
``parallel/mesh.py``): each rank steps on its rows of every global batch,
the fused tables (and tables of at least 65,536 rows) are row-sharded over
the model axis, and the result is that of ``mesh=None``.  ``predict`` and
``evaluate`` run the whole batch on every rank, which must all call them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..basic.callback import EarlyStopper
from ..basic.loss import RegularizationLoss, bce_with_logits
from ..basic.metric import auc_from_histogram, auc_histogram, auc_score
from ..parallel.distributed import mean_over_data
from ..utils.data import pad_batch
from .base import DictBatchTrainer, to_numpy, under_precision


class CTRTrainer(DictBatchTrainer):
    """Trains and evaluates a ranking model (dict input -> ``(B,)`` logits) on
    ``device``: the CUDA card unless the caller passes another
    (``device="cpu"``); with no card and no device it raises.

    ``precision="bf16"`` computes in bf16 (``basic/precision.py``); ``mesh``
    takes a ``parallel.mesh.DeviceMesh``; ``batch_size_hint`` is accepted and
    unused, as in the JAX package.
    """

    label_dtype = np.float32
    checkpoint_in_loop = True  # maybe_step_checkpoint after each group, as the JAX package's loop

    def __init__(self, model: torch.nn.Module, optimizer_params=None, regularization_params=None, scheduler_params=None, n_epoch: int = 10, earlystop_patience: int = 10, loss_mode: bool = True, model_path: str = "./", model_logger=None, mesh=None, seed: int = 0, batch_size_hint=None, steps_per_call: int = 1, sparse_embedding=None, precision=None, device=None):
        super().__init__(model, optimizer_params, scheduler_params, n_epoch, earlystop_patience, model_path, seed, model_logger, device, sparse_embedding, precision=precision, mesh=mesh)
        self.loss_mode = loss_mode
        self.reg_loss_fn = RegularizationLoss(**(regularization_params or {}))
        self.early_stopper = EarlyStopper(patience=earlystop_patience)
        self.steps_per_call = int(steps_per_call)

    @property
    def hyperparams(self):
        return {"loss_mode": self.loss_mode}

    # -- training ------------------------------------------------------------
    def loss_fn(self, x, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """The training loss of one padded batch (the model in train mode)."""
        out = self.model(x, generator=self.generator)
        aux = 0.0
        if not self.loss_mode:
            out, aux = out
            if self.mesh is not None:  # the model's mean over this rank's rows: the mean of the ranks' means
                aux = mean_over_data(aux * y.shape[0], torch.tensor(float(y.shape[0]), device=y.device), 1.0)
        loss = bce_with_logits(out, y, w) + aux
        if self.reg_loss_fn:  # the sparse tables take none, as in the JAX package
            loss = loss + self.penalty(self.reg_loss_fn, ((n, p) for n, p in self.model.named_parameters() if n not in self.sparse_tables))
        return loss

    # -- evaluation ----------------------------------------------------------
    @torch.inference_mode()
    @under_precision
    def _probabilities(self, x) -> torch.Tensor:
        out = self.model(x)
        if not self.loss_mode:
            out = out[0]
        return torch.sigmoid(out.to(torch.float32))

    def evaluate(self, model, data_loader, bucketed: bool = False, n_bins: int = 65536) -> float:
        """Validation AUC of the trainer's model (``model`` is taken for the JAX package's API).

        ``bucketed=False``: the exact tie-aware AUC on the host.
        ``bucketed=True``: per-batch (pos, neg) score histograms add up on
        the device and one scalar reaches the host; within 1e-4 of exact at
        the default bins.
        """
        if not bucketed:
            targets, predicts = self.predict(model, data_loader, return_targets=True)
            return auc_score(targets, predicts)
        self.model.eval()
        pos = neg = torch.zeros(n_bins, dtype=torch.float32, device=self.device)
        for x, y in data_loader:
            x, y, w = pad_batch(x, y, data_loader.batch_size)
            x, y, w = self._to_device(x, np.asarray(y, np.float32), w)
            p, n = auc_histogram(y, self._probabilities(x), n_bins=n_bins, weight=w)
            pos, neg = pos + p, neg + n
        return float(auc_from_histogram(pos, neg))

    def predict(self, model, data_loader, return_targets: bool = False):
        """fp32 probabilities of every row of ``data_loader`` (one host read at the end)."""
        self.model.eval()
        preds, targets = [], []
        for batch in data_loader:
            x, y = batch if isinstance(batch, tuple) else (batch, None)
            n = len(next(iter(x.values())))
            x, _, _ = pad_batch(x, None, data_loader.batch_size)
            (x,) = self._to_device(x)
            preds.append(self._probabilities(x).reshape(-1)[:n])
            if y is not None:
                targets.append(np.asarray(y).reshape(-1)[:n])
        preds = to_numpy(torch.cat(preds)) if preds else np.zeros(0)
        if return_targets:
            return np.concatenate(targets), preds
        return preds
