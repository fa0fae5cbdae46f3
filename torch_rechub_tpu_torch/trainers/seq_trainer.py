"""SeqTrainer: evaluation and serving of autoregressive sequence models (HSTU).

Counterpart of ``torch_rechub_tpu/trainers/seq_trainer.py``.  Batches are
``(seq_tokens, seq_positions, seq_time_diffs, targets)``; the loss is the
shifted next-token CE (labels ``concat(seq[1:], target)``, PAD positions
masked on the current token, the PAD logit clamped to -1e9), as plain
cross-entropy or temperature NCE; ``evaluate`` returns (mean batch loss,
top-1 hit rate on the held-out target) and ``predict_logits`` the
last-position logits.

This slice ports inference only: ``fit``/``train_one_epoch``, optimizers
and the sparse and sampled training steps come with the training slice.
The constructor takes the arguments that shape evaluation.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.chunked_ce import chunked_last_logits, chunked_next_token_loss, shifted_labels
from .base import resolve_device, to_numpy


def next_token_loss(logits: torch.Tensor, seq_tokens: torch.Tensor, targets: torch.Tensor, temperature: float = 1.0, ignore_index: int = 0) -> torch.Tensor:
    """Shifted next-token CE on dense ``(B, L, V)`` logits."""
    next_tokens = shifted_labels(seq_tokens, targets, 0)
    logits = logits.to(torch.float32).index_fill(-1, torch.zeros(1, dtype=torch.int64, device=logits.device), -1e9)
    log_probs = torch.log_softmax(logits / temperature, dim=-1)
    nll = -torch.gather(log_probs, -1, next_tokens[..., None])[..., 0]
    mask = (next_tokens != ignore_index).to(nll.dtype)
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


class SeqTrainer:
    """Evaluates a sequence model on ``device``: the CUDA card unless the caller
    passes another (``device="cpu"``); with no card and no device it raises."""

    def __init__(self, model: torch.nn.Module, loss_type: str = "cross_entropy", loss_params: Optional[dict] = None, vocab_chunk_size: Optional[int] = None, device=None):
        if loss_type not in ("cross_entropy", "nce", "sampled_softmax"):
            raise ValueError(f"loss_type must be cross_entropy|nce|sampled_softmax, got {loss_type!r}")
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
        self.device = resolve_device(device)
        self.model = model.to(self.device)

        self.temperature = float(self.loss_params.get("temperature", 1.0)) if loss_type == "nce" else 1.0
        self.ignore_index = int(self.loss_params.get("ignore_index", 0))
        # the dense path applies the model's own temperature inside forward;
        # the chunked path gets raw hidden states, so it is folded in here
        self.chunked_t = self.temperature * float(getattr(model, "temperature", 1.0))
        # evaluation always scores the full vocab; a sampled-softmax model
        # evaluates chunked so the (B, L, V) logits never form at large vocabs
        self.eval_chunk = vocab_chunk_size if vocab_chunk_size is not None else (8192 if loss_type == "sampled_softmax" else None)

    def _to_device(self, *arrays):
        return tuple(torch.as_tensor(np.asarray(a), device=self.device) for a in arrays)

    @torch.inference_mode()
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
    def predict_logits(self, data_loader) -> np.ndarray:
        """Last-position ``(N, V)`` logits, for ranking-style evaluation."""
        self.model.eval()
        out = []
        for seq_tokens, _pos, time_diffs, _targets in data_loader:
            toks, tds = self._to_device(seq_tokens, time_diffs)
            out.append(self.model(toks, tds)[:, -1, :])
        return to_numpy(torch.cat(out))
