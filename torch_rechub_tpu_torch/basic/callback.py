"""Training callbacks.

Counterpart of ``torch_rechub_tpu/basic/callback.py``: a patience counter on
the validation metric, with the best weights kept in memory and restored on
stop.  Torch tensors are mutable, so the caller hands in a detached copy of
the ``state_dict`` (JAX arrays are immutable, so there a reference is enough).
"""

from __future__ import annotations


class EarlyStopper:
    """Stop training when the validation metric has not improved for ``patience`` epochs."""

    def __init__(self, patience: int = 10):
        self.patience = patience
        self.trial_counter = 0
        self.best_auc = 0.0
        self.best_weights = None

    def stop_training(self, val_auc: float, weights) -> bool:
        """Record the metric; return True when patience is exhausted."""
        if val_auc > self.best_auc:
            self.best_auc = val_auc
            self.trial_counter = 0
            self.best_weights = weights
            return False
        if self.trial_counter + 1 < self.patience:
            self.trial_counter += 1
            return False
        return True
