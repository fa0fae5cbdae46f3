"""CTRTrainer: single-task binary CTR training, evaluation and prediction.

Counterpart of ``torch_rechub_tpu/trainers/ctr_trainer.py``.  A step is
eager PyTorch: the model's logits in train mode, BCE with logits weighted
by the padded batch's row weights (plus the regularization and, with
``loss_mode=False``, the model's auxiliary loss), ``backward``, the
optimizer.  Every batch is padded to the loader's ``batch_size`` by cycling
its rows, so BatchNorm sees the same batch as in the JAX package.
``steps_per_call`` groups run as that many single steps, which the JAX
package's scan equals.  ``fit`` runs epochs with StepLR and early stopping
on the validation AUC; ``predict`` returns fp32 probabilities of the real
rows; ``evaluate`` the exact AUC, or the bucketed one from histograms that
add up on the device.

``sparse_embedding="sgd" | "adagrad"`` updates the fused tables row by row
(``trainers/sparse.py``): Adam (and the regularization) cover the other
parameters only, the per-feature tables included.
"""

from __future__ import annotations

import numpy as np
import torch

from ..basic.callback import EarlyStopper
from ..basic.loss import RegularizationLoss, bce_with_logits
from ..basic.metric import auc_from_histogram, auc_histogram, auc_score
from ..utils.data import pad_batch
from .base import DictBatchTrainer, to_numpy, under_precision


class CTRTrainer(DictBatchTrainer):
    """Trains and evaluates a ranking model (dict input -> ``(B,)`` logits) on
    ``device``: the CUDA card unless the caller passes another
    (``device="cpu"``); with no card and no device it raises.

    ``precision="bf16"`` computes in bf16 (``basic/precision.py``); ``mesh``
    is not ported yet and raises; ``batch_size_hint`` is accepted and
    unused, as in the JAX package.
    """

    label_dtype = np.float32

    def __init__(self, model: torch.nn.Module, optimizer_params=None, regularization_params=None, scheduler_params=None, n_epoch: int = 10, earlystop_patience: int = 10, loss_mode: bool = True, model_path: str = "./", model_logger=None, mesh=None, seed: int = 0, batch_size_hint=None, steps_per_call: int = 1, sparse_embedding=None, precision=None, device=None):
        if mesh is not None:
            raise NotImplementedError("CTRTrainer(mesh=...) is not ported yet: the data / model mesh comes with ROADMAP queue 1, item 14")
        super().__init__(model, optimizer_params, scheduler_params, n_epoch, earlystop_patience, model_path, seed, model_logger, device, sparse_embedding, precision=precision)
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
        loss = bce_with_logits(out, y, w) + aux
        if self.reg_loss_fn:  # the sparse tables take none, as in the JAX package
            loss = loss + self.reg_loss_fn((n, p) for n, p in self.model.named_parameters() if n not in self.sparse_tables)
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
