"""Experiment-tracking interface.

Counterpart of ``torch_rechub_tpu/basic/tracking.py``: the ``BaseLogger``
interface (``log_metrics`` / ``log_hyperparams`` / ``finish``) and
``iter_loggers``, which is what the trainers call.  The concrete backends
(console, W&B, SwanLab, TensorBoardX) are not ported yet.
"""

from __future__ import annotations

import abc
from typing import Dict, Optional


class BaseLogger(abc.ABC):
    """Minimal tracking interface shared by all backends."""

    @abc.abstractmethod
    def log_metrics(self, metrics: Dict[str, float], step: Optional[int] = None):
        ...

    @abc.abstractmethod
    def log_hyperparams(self, params: Dict):
        ...

    def finish(self):
        pass


def iter_loggers(loggers):
    """Normalize a logger, list of loggers, or None into an iterable."""
    if loggers is None:
        return ()
    if isinstance(loggers, BaseLogger):
        return (loggers,)
    return tuple(loggers)
