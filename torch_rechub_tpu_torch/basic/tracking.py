"""Experiment-tracking interface.

Counterpart of ``torch_rechub_tpu/basic/tracking.py``: the ``BaseLogger``
interface (``log_metrics`` / ``log_hyperparams`` / ``finish``), the
dependency-free ``ConsoleLogger`` (printed lines, and the JAX package's JSON
lines in a file), the W&B, SwanLab and TensorBoardX backends (each imported
when the logger is made), and ``iter_loggers``, which is what the trainers
call.
"""

from __future__ import annotations

import abc
import json
import os
import time
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


class ConsoleLogger(BaseLogger):
    """Prints metrics; optionally appends JSON lines to ``log_path``."""

    def __init__(self, log_path: Optional[str] = None):
        self.log_path = log_path
        if log_path:
            os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)

    def log_metrics(self, metrics, step=None):
        print(f"[metrics step={step}] " + " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}" for k, v in metrics.items()))
        if self.log_path:
            with open(self.log_path, "a") as f:
                f.write(json.dumps({"ts": time.time(), "step": step, **metrics}) + "\n")

    def log_hyperparams(self, params):
        print(f"[hyperparams] {params}")
        if self.log_path:
            with open(self.log_path, "a") as f:
                f.write(json.dumps({"ts": time.time(), "hyperparams": params}, default=str) + "\n")


class WandbLogger(BaseLogger):
    """Weights & Biases adapter (``wandb`` imported when made)."""

    def __init__(self, project: str = "rechub-tpu", name: Optional[str] = None, config: Optional[Dict] = None, **kwargs):
        import wandb  # optional dependency

        self._run = wandb.init(project=project, name=name, config=config, **kwargs)
        self._wandb = wandb

    def log_metrics(self, metrics, step=None):
        self._run.log(metrics, step=step)

    def log_hyperparams(self, params):
        self._run.config.update(params, allow_val_change=True)

    def finish(self):
        self._run.finish()


class SwanLabLogger(BaseLogger):
    """SwanLab adapter (``swanlab`` imported when made)."""

    def __init__(self, project: str = "rechub-tpu", experiment_name: Optional[str] = None, config: Optional[Dict] = None, **kwargs):
        import swanlab  # optional dependency

        self._run = swanlab.init(project=project, experiment_name=experiment_name, config=config, **kwargs)
        self._swanlab = swanlab

    def log_metrics(self, metrics, step=None):
        self._swanlab.log(metrics, step=step)

    def log_hyperparams(self, params):
        self._run.config.update(params)

    def finish(self):
        self._swanlab.finish()


class TensorBoardXLogger(BaseLogger):
    """tensorboardX adapter (``tensorboardX`` imported when made)."""

    def __init__(self, log_dir: str = "./runs", **kwargs):
        from tensorboardX import SummaryWriter  # optional dependency

        os.makedirs(log_dir, exist_ok=True)
        self._writer = SummaryWriter(log_dir=log_dir, **kwargs)

    def log_metrics(self, metrics, step=None):
        for k, v in metrics.items():
            self._writer.add_scalar(k, v, global_step=step)

    def log_hyperparams(self, params):
        self._writer.add_text("hyperparams", json.dumps(params, default=str))

    def finish(self):
        self._writer.close()


def iter_loggers(loggers):
    """Normalize a logger, list of loggers, or None into an iterable."""
    if loggers is None:
        return ()
    if isinstance(loggers, BaseLogger):
        return (loggers,)
    return tuple(loggers)
