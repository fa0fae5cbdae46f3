"""SeqTrainer: training, evaluation and serving of autoregressive sequence models (HSTU).

Counterpart of ``torch_rechub_tpu/trainers/seq_trainer.py``.  Batches are
``(seq_tokens, seq_positions, seq_time_diffs, targets)``; the loss is the
shifted next-token CE (labels ``concat(seq[1:], target)``, PAD positions
masked on the current token, the PAD logit clamped to -1e9), as plain
cross-entropy, temperature NCE, the vocab-chunked CE (``vocab_chunk_size``)
or the sampled softmax.  ``fit`` runs epochs of Adam steps with StepLR and
early stopping on validation top-1; ``evaluate`` returns (mean batch loss,
top-1 hit rate on the held-out target) and ``predict_logits`` the
last-position logits.

A step is eager PyTorch: forward, loss, ``backward`` (through the CUDA
backward kernels of the attention on the card), ``optimizer.step``.
``steps_per_call`` is accepted for the JAX package's API; its groups run
as that many single steps, which the JAX package's scan equals.

``sparse_embedding="sgd" | "adagrad"`` (an untied model only) updates the
input token table row by row (``trainers/sparse.py``); under the sampled
softmax the output projection too, from the gathered candidate rows.  The
PAD row 0 is the Adagrad fill row of both: its embedding is masked out of
the forward, so it takes no update.

``precision="bf16"`` runs the model in bf16 (``basic/precision.py``): on
the card the attention goes through the bf16 kernels; the logits and the
losses are read in f32.

``mesh=`` trains over a (data, model) mesh of ranks (``trainers/base.py``,
``parallel/mesh.py``): each rank runs the layers (on the card K1, then K2 or
K2a + K2b) on its rows of every global batch; a vocab table of at least
65,536 rows is row-sharded over the model axis, the chunked CE runs each
rank's vocab chunks and combines the log-partitions over the model group,
and the sampled softmax's negatives are drawn at the global shape on every
rank, so they are ``mesh=None``'s.  ``evaluate`` and ``predict_logits`` run
the whole batch on every rank, which must all call them.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..basic.callback import EarlyStopper
from ..basic.tracking import iter_loggers
from ..ops import chunked_ce
from ..ops.chunked_ce import chunked_last_logits, chunked_next_token_loss, sampled_loss_from_rows, shifted_labels
from ..parallel.distributed import mean_over_data
from ..parallel.mesh import batch_sharding, scan_batch_sharding
from .base import TorchTrainer, to_numpy, under_precision
from .sparse import validate_method


def next_token_loss(logits: torch.Tensor, seq_tokens: torch.Tensor, targets: torch.Tensor, temperature: float = 1.0, ignore_index: int = 0) -> torch.Tensor:
    """Shifted next-token CE on dense ``(B, L, V)`` logits."""
    next_tokens = shifted_labels(seq_tokens, targets, 0)
    logits = logits.to(torch.float32).index_fill(-1, torch.zeros(1, dtype=torch.int64, device=logits.device), -1e9)
    log_probs = torch.log_softmax(logits / temperature, dim=-1)
    nll = -torch.gather(log_probs, -1, next_tokens[..., None])[..., 0]
    mask = (next_tokens != ignore_index).to(nll.dtype)
    return mean_over_data(torch.sum(nll * mask), torch.sum(mask), 1.0)


class SeqTrainer(TorchTrainer):
    """Trains and evaluates a sequence model on ``device``: the CUDA card
    unless the caller passes another (``device="cpu"``); with no card and
    no device it raises.  ``mesh`` takes a ``parallel.mesh.DeviceMesh``."""

    def __init__(self, model: torch.nn.Module, optimizer_params=None, scheduler_params=None, n_epoch: int = 10, earlystop_patience: int = 10, model_path: str = "./", loss_type: str = "cross_entropy", loss_params: Optional[dict] = None, model_logger=None, mesh=None, seed: int = 0, vocab_chunk_size: Optional[int] = None, steps_per_call: int = 1, sparse_embedding=None, precision=None, device=None):
        if loss_type not in ("cross_entropy", "nce", "sampled_softmax"):
            raise ValueError(f"loss_type must be cross_entropy|nce|sampled_softmax, got {loss_type!r}")
        if validate_method(sparse_embedding) and getattr(model, "tie_embeddings", False):
            raise ValueError(
                "SeqTrainer(sparse_embedding=...) requires an untied output projection "
                "(tie_embeddings=False): with tied embeddings the token table gets a dense "
                "gradient through the CE logits matmul, so sparse row-wise updates would "
                "silently drop it. Untie the model (or use the dense path for tied models)."
            )
        # the named tables the sparse path owns: the input token table; under
        # the sampled softmax the output projection too (only its candidate
        # rows are read there, where the full CE reads every row)
        sparse_names = ("token_embedding", "output_projection") if loss_type == "sampled_softmax" else ("token_embedding",)
        super().__init__(model, optimizer_params, scheduler_params, n_epoch, earlystop_patience, model_path, seed, model_logger, device, sparse_embedding, sparse_names, spare_rows={"token_embedding": 0, "output_projection": 0}, precision=precision, mesh=mesh)
        self.loss_type = loss_type
        if loss_type == "nce":
            self.loss_params = loss_params or {"temperature": 0.1, "ignore_index": 0}
        elif loss_type == "sampled_softmax":
            self.loss_params = {"num_negatives": 1024, "ignore_index": 0, **(loss_params or {})}
        else:
            self.loss_params = loss_params or {"ignore_index": 0}
        # When set, the (B, L, V) logits are never formed: the model returns
        # hidden states and the CE runs over vocab chunks of this size.
        self.vocab_chunk_size = vocab_chunk_size
        self.steps_per_call = int(steps_per_call)
        self.early_stopper = EarlyStopper(patience=earlystop_patience)

        self.temperature = float(self.loss_params.get("temperature", 1.0)) if loss_type == "nce" else 1.0
        self.ignore_index = int(self.loss_params.get("ignore_index", 0))
        # the dense path applies the model's own temperature inside forward;
        # the chunked path gets raw hidden states, so it is folded in here
        self.chunked_t = self.temperature * float(getattr(model, "temperature", 1.0))
        # sampled softmax: the loss-level temperature times the model's own
        self.sampled_t = float(self.loss_params.get("temperature", 1.0)) * float(getattr(model, "temperature", 1.0))
        # evaluation always scores the full vocab; a sampled-softmax model
        # evaluates chunked so the (B, L, V) logits never form at large vocabs
        self.eval_chunk = vocab_chunk_size if vocab_chunk_size is not None else (8192 if loss_type == "sampled_softmax" else None)

    def _to_device(self, *arrays):
        return tuple(torch.as_tensor(np.asarray(a), device=self.device) for a in arrays)

    # -- training ------------------------------------------------------------
    def loss_fn(self, seq_tokens: torch.Tensor, time_diffs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """The training loss of one batch (the model in train mode, dropout
        from the trainer's generator)."""
        model, gen, ignore = self.model, self.generator, self.ignore_index
        if self.loss_type == "sampled_softmax":
            out = model(seq_tokens, time_diffs, return_hidden=True, generator=gen)
            p = self.loss_params
            next_tokens, negs = chunked_ce.sampled_candidates(seq_tokens, targets, gen, model.vocab_size, int(p["num_negatives"]), ignore)
            bias = out["bias"]
            b_pos, b_neg = (None, None) if bias is None else (bias[next_tokens], bias[negs])
            return sampled_loss_from_rows(out["hidden"], model.output_rows(next_tokens), model.output_rows(negs), b_pos, b_neg, next_tokens, negs, model.vocab_size, self.sampled_t, ignore, bool(p.get("remove_accidental_hits", True)), bool(p.get("logq_correction", True)))
        if self.vocab_chunk_size is not None:
            out = model(seq_tokens, time_diffs, return_hidden=True, generator=gen)
            return chunked_next_token_loss(out["hidden"], out["weight"], seq_tokens, targets, out["bias"], self.chunked_t, ignore, self.vocab_chunk_size)
        logits = model(seq_tokens, time_diffs, generator=gen)
        return next_token_loss(logits, seq_tokens, targets, self.temperature, ignore)

    def _iter_groups(self, data_loader):
        """Yield stacked ``(n, B, ...)`` groups of full-size batches and plain
        ``(B, ...)`` odd-size tail batches (told apart by tokens.ndim),
        preserving step order."""
        batch_size = getattr(data_loader, "batch_size", None)
        pending = []

        def stacked():
            return tuple(np.stack([b[i] for b in pending]) for i in range(3))

        for seq_tokens, _pos, time_diffs, targets in data_loader:
            batch = (np.asarray(seq_tokens), np.asarray(time_diffs), np.asarray(targets).reshape(-1))
            if self.steps_per_call > 1 and (batch_size is None or len(batch[2]) == batch_size):
                pending.append(batch)
                if len(pending) >= self.steps_per_call:
                    yield stacked()
                    pending = []
            else:
                if pending:
                    yield stacked()
                    pending = []
                yield batch
        if pending:
            yield stacked()

    def train_one_epoch(self, data_loader, log_interval: int = 10, lr: Optional[float] = None) -> float:
        """One pass over ``data_loader``; returns the mean step loss (one host sync at the end)."""
        self.set_lr(self.lr0 if lr is None else lr)
        losses = []
        n_seen = 0
        t0 = time.perf_counter()
        for gi, (toks, tds, tgts) in enumerate(self._iter_groups(data_loader)):
            if self.mesh is not None:  # this rank's rows: axis 1 of a stacked group, else axis 0
                sharding = (scan_batch_sharding if toks.ndim == 3 else batch_sharding)(self.mesh)
                toks, tds, tgts = sharding.local(toks), sharding.local(tds), sharding.local(tgts)
            toks, tds, tgts = self._to_device(toks, tds, tgts)
            # a stacked (n, B, L) group runs as n single steps
            for s_toks, s_tds, s_tgts in (zip(toks, tds, tgts) if toks.ndim == 3 else [(toks, tds, tgts)]):
                losses.append(self.train_step(s_toks, s_tds, s_tgts))
                n_seen += int(s_tgts.shape[0])
            if log_interval and (gi + 1) % log_interval == 0:
                print(f"  train {n_seen} sequences, loss {float(losses[-1]):.5f}, {n_seen / (time.perf_counter() - t0):,.0f} seq/s")
        return float(to_numpy(torch.stack(losses)).mean()) if losses else 0.0

    def fit(self, train_dataloader, val_dataloader=None):
        for logger in iter_loggers(self.loggers):
            logger.log_hyperparams({"n_epoch": self.n_epoch, "learning_rate": self.lr0, "loss_type": self.loss_type})
        for epoch_i in range(self.n_epoch):
            lr = self.epoch_lr(epoch_i)
            t0 = time.perf_counter()
            train_loss = self.train_one_epoch(train_dataloader, lr=lr)
            print(f"epoch: {epoch_i} train loss: {train_loss:.5f} ({time.perf_counter() - t0:.2f}s)")
            for logger in iter_loggers(self.loggers):
                logger.log_metrics({"train/loss": train_loss, "learning_rate": lr}, step=epoch_i)
            if val_dataloader is not None:
                val_loss, accuracy = self.evaluate(val_dataloader)
                print(f"epoch: {epoch_i} val loss: {val_loss:.5f} top1 acc: {accuracy:.5f}")
                for logger in iter_loggers(self.loggers):
                    logger.log_metrics({"val/loss": val_loss, "val/top1_acc": accuracy}, step=epoch_i)
                weights = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
                if self.early_stopper.stop_training(accuracy, weights):
                    print(f"validation: best top1 acc: {self.early_stopper.best_auc}")
                    break
        if val_dataloader is not None and self.early_stopper.best_weights is not None:
            self.model.load_state_dict(self.early_stopper.best_weights)
        self.save()
        for logger in iter_loggers(self.loggers):
            logger.finish()

    # -- evaluation ----------------------------------------------------------
    @torch.inference_mode()
    @under_precision
    def eval_step(self, seq_tokens: torch.Tensor, time_diffs: torch.Tensor, targets: torch.Tensor):
        """``(loss, top-1 predictions)`` of one batch, both on the device."""
        model = self.model
        ignore = self.ignore_index
        if self.eval_chunk is not None:
            out = model(seq_tokens, time_diffs, return_hidden=True)
            loss = chunked_next_token_loss(out["hidden"], out["weight"], seq_tokens, targets, out["bias"], self.chunked_t, ignore, self.eval_chunk)
            last = chunked_last_logits(out["hidden"][:, -1, :], out["weight"], out["bias"], self.chunked_t)
            last[:, ignore] = -1e9
            return loss, torch.argmax(last, dim=-1)
        logits = model(seq_tokens, time_diffs)
        loss = next_token_loss(logits, seq_tokens, targets, self.temperature, ignore)
        last = logits[:, -1, :].clone()
        last[:, 0] = -1e9
        return loss, torch.argmax(last, dim=-1)

    def evaluate(self, data_loader):
        """(mean of the batch losses, top-1 accuracy); one host sync at the end."""
        self.model.eval()
        losses, correct, total = [], [], 0
        for seq_tokens, _pos, time_diffs, targets in data_loader:
            targets = np.asarray(targets).reshape(-1)
            toks, tds, tgts = self._to_device(seq_tokens, time_diffs, targets)
            loss, preds = self.eval_step(toks, tds, tgts)
            losses.append(loss)
            correct.append(torch.sum(preds == tgts))
            total += len(targets)
        if not losses:
            return 0.0, 0.0
        total_loss = sum(to_numpy(torch.stack(losses)).tolist())
        total_correct = int(to_numpy(torch.stack(correct)).sum())
        return total_loss / len(losses), total_correct / max(total, 1)

    @torch.inference_mode()
    @under_precision
    def predict_logits(self, data_loader) -> np.ndarray:
        """Last-position ``(N, V)`` logits, for ranking-style evaluation."""
        self.model.eval()
        out = []
        for seq_tokens, _pos, time_diffs, _targets in data_loader:
            toks, tds = self._to_device(seq_tokens, time_diffs)
            out.append(self.model(toks, tds)[:, -1, :])
        return to_numpy(torch.cat(out))
