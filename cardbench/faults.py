"""Faults planted underneath the timed path, which the comparison has to catch (``correct`` false).

Training faults take the program's trainer and replace its ``train_step``;
serving faults take the served call and return a broken one.
"""

from __future__ import annotations

import torch


def _half(x):
    if isinstance(x, dict):
        return {k: _half(v) for k, v in x.items()}
    return x[: x.shape[0] // 2] if isinstance(x, torch.Tensor) and x.ndim else x


def unchanged(trainer) -> None:
    """A step that returns its state unchanged: the loss of the batch, and no update."""

    def step(*batch):
        trainer.model.train()
        with torch.no_grad():
            return trainer.loss_fn(*batch).detach()

    trainer.train_step = step


def half_batch(trainer) -> None:
    """Half of the batch left out: the step takes the first half of the rows, its mean over them."""
    step = trainer.train_step
    trainer.train_step = lambda *batch: step(*(_half(b) for b in batch))


def altered_answer(serve):
    """An answer altered where it is produced: the first user's best item replaced by the next id."""

    def broken(model, b, k):
        ids, scores = serve(model, b, k)
        ids = ids.copy()
        ids[0, 0] = (ids[0, 0] + 1) % (ids.max() + 2)
        return ids, scores

    return broken


def half_answered(serve):
    """Half of the batch left out: only the first half of the users are answered."""

    def broken(model, b, k):
        ids, scores = serve(model, b, k)
        return ids[: len(ids) // 2], scores[: len(scores) // 2]

    return broken


TRAIN = {"unchanged": unchanged, "half_batch": half_batch}
SERVE = {"altered_answer": altered_answer, "half_answered": half_answered}
