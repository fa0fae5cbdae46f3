"""MatchTrainer: two-tower retrieval training, evaluation and tower embeddings.

Counterpart of ``torch_rechub_tpu/trainers/match_trainer.py``.  Three
training modes: 0 point-wise BCE on the model's scores, 1 pair-wise BPR on
``(pos, neg)`` scores, 2 list-wise cross-entropy on ``(B, 1 + n_neg)``
scores with the positive in column 0.  With ``in_batch_neg`` the trainer
takes both towers (``model.towers``), scores every user against every item
of the batch (``(B, B)``), samples ``in_batch_neg_ratio`` negatives per row
(uniform from the sampler's generator, or the hardest with
``hard_negative``), and takes BPR (mode 1) or the cross-entropy (modes 0
and 2) over the gathered ``(B, 1 + K)`` logits.  The models return raw
scores; the losses take logits.

A step is eager PyTorch on ``TorchTrainer.train_step``; ``steps_per_call``
groups run as that many single steps.  ``sparse_embedding="sgd" |
"adagrad"`` updates the fused tables row by row (``trainers/sparse.py``):
the gather hooks record inside the towers on the in-batch path as on the
others.  ``inference_embedding`` streams a tower's embeddings from the best
checkpoint.

``mesh=`` trains over a (data, model) mesh of ranks (``trainers/base.py``).
``neg_pool="global"`` (the default) scores this rank's users against the
item tower gathered over the data group (its gradient summed back), so the
pool, and the uniform draws, are ``mesh=None``'s; ``"local"`` scores each
data rank's own ``(b, b)`` block with negatives from that rank's generator
(``utils.match.local_inbatch_loss``).  Without a data axis both mean the
whole batch, as in the JAX package.

The uniform in-batch draws and MIND's routing start come from the
trainer's generators, not JAX's streams.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..basic.callback import EarlyStopper
from ..basic.loss import RegularizationLoss, bce_with_logits, bpr_loss, softmax_cross_entropy
from ..basic.metric import auc_score
from ..utils.data import pad_batch
from ..parallel.distributed import gather_partitioned, global_batch_seed
from ..utils.match import gather_inbatch_logits, inbatch_negative_sampling, local_inbatch_loss
from .base import DictBatchTrainer, to_numpy, under_precision


def _flat_tower(emb: torch.Tensor) -> torch.Tensor:
    """A ``(B, 1, D)`` tower output as ``(B, D)``; any other shape as it is."""
    return emb.reshape(emb.shape[0], -1) if emb.ndim == 3 and emb.shape[1] == 1 else emb


class MatchTrainer(DictBatchTrainer):
    """Trains a matching model on ``device``: the CUDA card unless the caller passes another
    (``device="cpu"``); with no card and no device it raises.

    ``precision="bf16"`` computes in bf16 (``basic/precision.py``); scores and
    tower embeddings are read in f32.  ``mesh`` takes a ``parallel.mesh.DeviceMesh``.
    """

    def __init__(self, model: torch.nn.Module, mode: int = 0, in_batch_neg: bool = False, in_batch_neg_ratio: Optional[int] = None, hard_negative: bool = False, neg_pool: str = "global", sampler_seed: Optional[int] = None, optimizer_params=None, regularization_params=None, scheduler_params=None, n_epoch: int = 10, earlystop_patience: int = 10, model_path: str = "./", model_logger=None, mesh=None, seed: int = 0, steps_per_call: int = 1, sparse_embedding=None, precision=None, device=None):
        if mode not in (0, 1, 2):
            raise ValueError(f"mode only contain value in [0, 1, 2], but got {mode}")
        if neg_pool not in ("global", "local"):
            raise ValueError(f"neg_pool must be 'global' or 'local', got {neg_pool!r}")
        super().__init__(model, optimizer_params, scheduler_params, n_epoch, earlystop_patience, model_path, seed, model_logger, device, sparse_embedding, precision=precision, mesh=mesh)
        self.mode = mode
        self.in_batch_neg, self.in_batch_neg_ratio, self.hard_negative = in_batch_neg, in_batch_neg_ratio, hard_negative
        self.neg_pool = neg_pool
        self.sampler_seed = sampler_seed if sampler_seed is not None else seed
        self.sampler = torch.Generator(device=self.device).manual_seed(self.sampler_seed)
        # the local pool differs from the global one only where the batch splits over a data axis
        self.local_pool = neg_pool == "local" and mesh is not None and mesh.shape["data"] > 1
        if self.local_pool:  # each data rank draws from a stream of its own
            self.sampler = torch.Generator(device=self.device).manual_seed(global_batch_seed(self.sampler_seed, 1 + mesh.data_index))
        self.reg_loss_fn = RegularizationLoss(**(regularization_params or {}))
        self.early_stopper = EarlyStopper(patience=earlystop_patience)
        self.steps_per_call = int(steps_per_call)

    @property
    def hyperparams(self):
        return {"loss_mode": self.mode}

    # -- training ------------------------------------------------------------
    def _mode_loss(self, x, y: Optional[torch.Tensor], w: torch.Tensor) -> torch.Tensor:
        """The mode's loss of one padded batch (the model in train mode), without the regularization."""
        model, gen = self.model, self.generator
        if self.in_batch_neg:
            user, item = (_flat_tower(e) for e in model.towers(x, generator=gen))
            if self.local_pool:
                return local_inbatch_loss(user, item, w, self.sampler, self.mesh, self.mode, self.in_batch_neg_ratio, self.hard_negative)
            offset = 0
            if self.mesh is not None:  # the global batch's items; this rank's users are its rows from offset on
                item, offset = gather_partitioned(item, self.mesh.data_group), self.mesh.data_index * user.shape[0]
            scores = user @ item.T  # (b, B)
            neg_idx = inbatch_negative_sampling(scores, self.in_batch_neg_ratio, self.hard_negative, generator=self.sampler, row_offset=offset)
            logits = gather_inbatch_logits(scores, neg_idx, row_offset=offset)
            if self.mode == 1:
                return bpr_loss(logits[:, 0], logits[:, 1:], w)
            return softmax_cross_entropy(logits, torch.zeros(logits.shape[0], dtype=torch.int64, device=logits.device), w)
        out = model(x, generator=gen)
        if self.mode == 1:
            return bpr_loss(*out, w)
        if self.mode == 2:
            return softmax_cross_entropy(out, y.to(torch.int64), w)
        return bce_with_logits(out, y.to(torch.float32), w)

    def loss_fn(self, x, y: Optional[torch.Tensor], w: torch.Tensor) -> torch.Tensor:
        loss = self._mode_loss(x, y, w)
        if self.reg_loss_fn:  # the sparse tables take none, as in the JAX package
            loss = loss + self.penalty(self.reg_loss_fn, ((n, p) for n, p in self.model.named_parameters() if n not in self.sparse_tables))
        return loss

    # -- evaluation ----------------------------------------------------------
    @torch.inference_mode()
    @under_precision
    def _outputs(self, data_loader, take, mode=None):
        """``(fp32 outputs, labels)`` of ``data_loader``, the model in eval mode, read as the
        JAX package reads them: a ``(pos, neg)`` pair stacked (its ``to_numpy``), then ``take(out, n)`` of each
        padded batch's output (``n`` its real rows), concatenated on the device; the loader's labels (numpy,
        or None), in one pass."""
        self.model.eval()
        out, targets = [], []
        for batch in data_loader:
            x, y = batch if isinstance(batch, tuple) else (batch, None)
            n = len(next(iter(x.values())))
            x, _, _ = pad_batch(x, None, data_loader.batch_size)
            (x,) = self._to_device(x)
            scores = self.model(x, mode=mode)
            scores = torch.stack(scores) if isinstance(scores, tuple) else scores
            out.append(take(scores.to(torch.float32), n))
            if y is not None:
                targets.append(np.asarray(y).reshape(-1)[:n])
        return torch.cat(out), (np.concatenate(targets) if targets else None)

    def evaluate(self, model, data_loader) -> float:
        """The validation AUC (``model`` is taken for the JAX package's API).

        As in the JAX package, each padded batch's output is flattened and
        its first ``n`` values are scored against the ``n`` labels: mode 0's
        one score per row; a pair-wise model's positive scores (the pair is
        stacked ``(2, B, ...)``); a list-wise model's ``(B, 1 + n_neg)``
        scores row after row, so the positive column mixes with the others
        (a mirrored quirk, ``ROADMAP.md`` queue 3).
        """
        preds, targets = self._outputs(data_loader, lambda out, n: out.reshape(-1)[:n])
        return auc_score(targets, to_numpy(preds))

    def predict(self, model, data_loader) -> np.ndarray:
        """The model's fp32 output on every batch of ``data_loader`` (one host read at the end): each padded
        batch's output cut to its first ``n`` entries on the first axis, as the JAX package cuts it, so a
        ``(pos, neg)`` pair comes back stacked ``(2, B, ...)`` per batch."""
        return to_numpy(self._outputs(data_loader, lambda out, n: out[:n])[0])

    def inference_embedding(self, model, mode: str, data_loader, model_path) -> np.ndarray:
        """One tower's embeddings of every row of ``data_loader`` (``mode="user" | "item"``), from the
        checkpoint ``model.pt`` in ``model_path`` when there is one (the best one after ``fit``)."""
        assert mode in ("user", "item"), f"Invalid mode={mode}."
        target = os.path.join(model_path or ".", "model.pt")
        if model_path and os.path.exists(target):
            self.load_weights(target)
        return to_numpy(self._outputs(data_loader, lambda out, n: out[:n], mode=mode)[0])
