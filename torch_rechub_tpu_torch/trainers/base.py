"""Shared trainer machinery: device, optimizer, learning-rate schedule, checkpoints.

Counterpart of ``torch_rechub_tpu/trainers/base.py``.  The JAX trainers run
one jitted step around ``optax``; here a step is eager PyTorch around
``torch.optim.Adam``, which computes the same update (see
:func:`make_optimizer`).  The learning rate is set per epoch on the
optimizer's parameter groups (:func:`step_lr`).  ``precision=`` (None,
``"f32"``, ``"bf16"``; ``basic/precision.py``) is validated when a trainer is
made, and every forward a trainer runs (the training step, evaluation,
prediction, tower embeddings) runs under it: parameters and optimizer
state stay float32.  ``TorchTrainer`` also carries the JAX trainer's
lifecycle: the step count and full train state, step checkpoints and
exact resume (``utils/checkpoint.py``), ``export`` / ``export_quantized``
(``utils/export.py``) and ``visualization`` (``utils/model_utils.py``).

``mesh=`` (a ``parallel.mesh.DeviceMesh``, every rank of it running the
same trainer on the same loader) trains as ``mesh=None`` does over the same
global batches: the parameters are placed at construction
(``parallel.mesh.shard_params``: tables row-sharded over the model axis,
the rest replicated), each step keeps this rank's rows of the batch, the
losses and BatchNorm's statistics are the global batch's, and the
gradients are summed over the data group before the optimizer; the sparse
row updates dedup over the global batch.  ``train_state()`` is the
unsharded state, so a checkpoint moves between meshes; rank 0 writes it.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..basic.loss import classify_param
from ..basic.precision import _resolve, precision_scope
from ..basic.tracking import iter_loggers
from ..ops.sparse_update import record_rows
from ..parallel import distributed as pdist
from ..parallel import mesh as mesh_lib
from ..utils.data import pad_batch
from .sparse import apply_sparse_table_updates, init_sparse_opt_state, validate_method


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names another.

    ``None`` means the current CUDA device; with no CUDA device that raises
    rather than quietly running on the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found: pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def under_precision(method):
    """Run a trainer method under the trainer's compute precision (``precision_scope(self.precision)``)."""

    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        with precision_scope(self.precision):
            return method(self, *args, **kwargs)

    return wrapped


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class TableOptimizer(torch.optim.Optimizer):
    """The update of embedding tables under ``embedding_optimizer``, ``p ← p − lr·u``.

    ``"adagrad"`` is optax's ``scale_by_rss(initial_accumulator_value, eps)``:
    ``acc ← acc + g²`` from ``acc = initial_accumulator_value``, then
    ``u = g · rsqrt(acc + eps)`` where ``acc > 0``, else 0.  That is not
    ``torch.optim.Adagrad``, which starts the sum at 0 and adds eps outside
    the square root.  ``"sgd"`` is ``u = g``.  Neither decays weights.
    """

    def __init__(self, params, lr: float, rule: str = "adagrad", initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        if rule not in ("adagrad", "sgd"):
            raise ValueError(f"unknown embedding_optimizer {rule!r}")
        super().__init__(params, dict(lr=lr, rule=rule, initial_accumulator_value=initial_accumulator_value, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["rule"] == "adagrad":
                    state = self.state[p]
                    if not state:
                        state["sum_of_squares"] = torch.full_like(p, group["initial_accumulator_value"])
                    acc = state["sum_of_squares"]
                    acc.add_(g * g)
                    g = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]), 0.0) * g
                p.sub_(group["lr"] * g)


class SplitOptimizer:
    """Adam for the dense parameters and a :class:`TableOptimizer` for the
    embedding tables, stepped, zeroed and scheduled as one optimizer."""

    def __init__(self, *optimizers: torch.optim.Optimizer):
        self.optimizers = optimizers

    @property
    def param_groups(self):
        return [g for opt in self.optimizers for g in opt.param_groups]

    def step(self):
        for opt in self.optimizers:
            opt.step()

    def zero_grad(self, set_to_none: bool = True):
        for opt in self.optimizers:
            opt.zero_grad(set_to_none=set_to_none)

    def state_dict(self) -> Dict:
        return {"optimizers": [opt.state_dict() for opt in self.optimizers]}

    def load_state_dict(self, state: Dict) -> None:
        if len(state["optimizers"]) != len(self.optimizers):
            raise ValueError(f"the state holds {len(state['optimizers'])} optimizers, this trainer {len(self.optimizers)}")
        for opt, sd in zip(self.optimizers, state["optimizers"]):
            opt.load_state_dict(sd)


def make_optimizer(parameters: Iterable, optimizer_params: Optional[Dict] = None):
    """``(optimizer, lr0)``, the update of the JAX package's ``make_optimizer``.

    There, ``add_decayed_weights(wd)`` then ``scale_by_adam(b1)`` with the
    learning rate applied outside: weight decay added to the gradient, then
    bias-corrected Adam with eps 1e-8 outside the square root, which is
    ``torch.optim.Adam(weight_decay=wd)``.  Only ``betas[0]`` is read there,
    so b2 is 0.999 whatever ``betas`` says.

    ``embedding_optimizer`` (``"adagrad" | "sgd"``) gives the parameters that
    :func:`classify_param` calls "embedding" a :class:`TableOptimizer` and
    the rest Adam, as optax's ``multi_transform`` does there; it needs
    ``parameters`` as ``(name, parameter)`` pairs (``named_parameters()``).
    """
    optimizer_params = dict(optimizer_params or {"lr": 1e-3, "weight_decay": 1e-5})
    lr = float(optimizer_params.pop("lr", 1e-3))
    wd = float(optimizer_params.pop("weight_decay", 0.0))
    b1 = float(optimizer_params.pop("betas", (0.9, 0.999))[0]) if "betas" in optimizer_params else 0.9
    emb_opt = optimizer_params.pop("embedding_optimizer", None)
    parameters = list(parameters)
    named = bool(parameters) and isinstance(parameters[0], tuple)

    def adam(params):
        return torch.optim.Adam(params, lr=lr, betas=(b1, 0.999), eps=1e-8, weight_decay=wd)

    if emb_opt is None:
        return adam([p for _, p in parameters] if named else parameters), lr
    if emb_opt not in ("adagrad", "sgd"):
        raise ValueError(f"unknown embedding_optimizer {emb_opt!r}")
    if not named:
        raise ValueError("embedding_optimizer sorts parameters by name: pass named_parameters()")
    tables = [p for name, p in parameters if classify_param(name) == "embedding"]
    dense = [p for name, p in parameters if classify_param(name) != "embedding"]
    parts = ([adam(dense)] if dense else []) + ([TableOptimizer(tables, lr, emb_opt)] if tables else [])
    return SplitOptimizer(*parts), lr


def step_lr(lr0: float, epoch: int, scheduler_params: Optional[Dict]) -> float:
    """StepLR at epoch granularity: ``lr0 * gamma ** (epoch // step_size)``."""
    if not scheduler_params:
        return lr0
    step_size = int(scheduler_params.get("step_size", 1))
    gamma = float(scheduler_params.get("gamma", 0.1))
    return lr0 * gamma ** (epoch // step_size)


class TorchTrainer:
    """What the concrete trainers share: the device, the optimizer, a seeded
    ``torch.Generator`` on the device (dropout masks, sampled negatives),
    the per-epoch learning rate, the training step over the subclass's
    ``loss_fn``, the ``state_dict`` checkpoint, and the lifecycle of the
    JAX package's ``JaxTrainer``: the step count, the full train state with
    step checkpoints and exact resume, export (full size or quantized) and
    the model summary.

    The train state is what the JAX package's ``TrainState`` holds: the
    model's ``state_dict`` (parameters, and the BatchNorm statistics of
    ``batch_stats``), the optimizer's state (optax's ``opt_state``), the
    sparse tables' accumulators (the sparse ``opt_state``) and ``step``.
    The generator's state is not part of it, as ``JaxTrainer._rng`` is not
    part of ``TrainState``: a resumed run with dropout or sampled negatives
    draws afresh, in both packages.
    """

    def __init__(self, model: torch.nn.Module, optimizer_params=None, scheduler_params=None, n_epoch: int = 10, earlystop_patience: int = 10, model_path: str = "./", seed: int = 0, loggers=None, device=None, sparse_embedding=None, sparse_names: Tuple[str, ...] = (), spare_rows: Optional[Dict[str, int]] = None, extra_params: Tuple[Tuple[str, torch.Tensor], ...] = (), precision=None, mesh=None):
        # extra_params: ``(name, tensor)`` pairs outside the model that the dense optimizer steps too
        # (MTLTrainer's loss weights)
        _resolve(precision)  # validated before anything moves
        self.mesh = mesh_lib.check_mesh(mesh)
        self.precision = precision
        self.device = resolve_device(device)
        self.model = mesh_lib.shard_params(model.to(self.device), mesh)  # placed before the optimizer state is made
        # sparse_embedding: the tables the row-wise updates own, their
        # accumulators and fill rows (trainers/sparse.py); the dense optimizer
        # covers the other parameters
        self.sparse_embedding = validate_method(sparse_embedding)
        self.sparse_tables: Dict[str, torch.Tensor] = {}
        self.sparse_accums: Dict[str, torch.Tensor] = {}
        self.spare_rows = dict(spare_rows or {})
        dense = list(self.model.named_parameters())
        if self.sparse_embedding:
            self.sparse_tables, self.sparse_accums, dense = init_sparse_opt_state(self.model, sparse_names)
        self.optimizer, self.lr0 = make_optimizer(dense + list(extra_params), optimizer_params)
        self.lr = self.lr0  # the learning rate of the epoch (set_lr); the sparse table updates read it
        self.scheduler_params = scheduler_params
        self.n_epoch = n_epoch
        self.earlystop_patience = earlystop_patience
        self.model_path = model_path
        self.seed = seed
        self.loggers = loggers
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.step = 0  # optimizer steps taken (TrainState.step)
        self._weights_loaded = False  # load() or load_train_state() gave the model its weights
        self._ckpt = None
        self._ckpt_every = 0

    def epoch_lr(self, epoch: int) -> float:
        return step_lr(self.lr0, epoch, self.scheduler_params)

    def set_lr(self, lr: float) -> None:
        self.lr = lr
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    @under_precision
    def train_step(self, *batch) -> torch.Tensor:
        """One optimizer step on one batch (the arguments of ``loss_fn``); returns the loss on the device (no host sync).

        The sparse tables' gather hooks record inside the loss; after the
        dense optimizer, their rows update (``trainers/sparse.py``).  With
        no sparse tables nothing records and nothing more is done.
        """
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        with record_rows(self.sparse_tables) as rec, pdist.data_parallel(self.mesh):
            loss = self.loss_fn(*batch)
        loss.backward()
        group = None if self.mesh is None else self.mesh.data_group
        if group is not None:
            pdist.all_reduce_gradients([p for g in self.optimizer.param_groups for p in g["params"]], group)
        self.optimizer.step()
        apply_sparse_table_updates(self.sparse_tables, self.sparse_accums, rec.records, self.sparse_embedding, self.lr, self.spare_rows, data_group=group)
        self.step += 1
        return loss.detach()

    def penalty(self, reg_loss_fn, named_parameters) -> torch.Tensor:
        """``reg_loss_fn`` over ``named_parameters``; under a mesh its value is the whole model's (a row shard's part
        summed over the model group) and its gradient is carried by data index 0 alone, so that the data group's
        gradient sum counts it once."""
        if self.mesh is None:
            return reg_loss_fn(named_parameters)
        named = list(named_parameters)
        shards = [(n, p) for n, p in named if mesh_lib.row_shard(p) is not None]
        total = reg_loss_fn([(n, p) for n, p in named if mesh_lib.row_shard(p) is None])
        if shards:
            total = total + pdist.sum_replicated(reg_loss_fn(shards), self.mesh.model_group)
        return total if self.mesh.data_index == 0 else total.detach()

    def _writes(self) -> bool:
        """Whether this process writes files (checkpoints, the model): always without a mesh, rank 0 under one."""
        return self.mesh is None or torch.distributed.get_rank() == 0

    def _check_no_mesh(self, what: str) -> None:
        if self.mesh is not None:
            raise NotImplementedError(f"{what}() under a mesh: load train_state() into a trainer without one and call it there")

    # -- the train state and step checkpoints (preemption-safe resume) --------
    def train_state(self) -> Dict:
        """The full train state, as references to the live tensors (``torch.save`` it, or copy it to keep it).

        Under a mesh the row shards are gathered (every rank calls it): the
        state is the unsharded one, which loads under any mesh or none.
        """
        state = {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(), "sparse_accums": dict(self.sparse_accums), "step": self.step}
        if self.mesh is None:
            return state
        return self._map_shards(state, mesh_lib.unshard)

    def _map_shards(self, state: Dict, fn) -> Dict:
        """``state`` with ``fn(tensor, parameter)`` applied to each tensor that belongs to a parameter (its value,
        its optimizer state, its sparse accumulator)."""
        params = dict(self.model.named_parameters())
        model = {k: fn(v, params[k]) if k in params else v for k, v in state["model"].items()}
        parts = getattr(self.optimizer, "optimizers", [self.optimizer])
        dicts = state["optimizer"]["optimizers"] if isinstance(self.optimizer, SplitOptimizer) else [state["optimizer"]]
        mapped = []
        for opt, sd in zip(parts, dicts):
            plist = [p for g in opt.param_groups for p in g["params"]]
            mapped.append({**sd, "state": {i: {k: fn(v, plist[int(i)]) if isinstance(v, torch.Tensor) and v.ndim else v for k, v in st.items()} for i, st in sd["state"].items()}})
        optimizer = {"optimizers": mapped} if isinstance(self.optimizer, SplitOptimizer) else mapped[0]
        accums = {k: fn(v, self.sparse_tables[k]) for k, v in state["sparse_accums"].items()}
        return {**state, "model": model, "optimizer": optimizer, "sparse_accums": accums}

    def load_train_state(self, state: Dict) -> None:
        """Load a state of :meth:`train_state`'s structure into this trainer, in place (under a mesh, this rank's
        rows of each row shard's whole-table tensors)."""
        if self.mesh is not None:
            state = self._map_shards(state, mesh_lib.reshard)
        self.model.load_state_dict(state["model"])
        check_optimizer_state(state["optimizer"], self.optimizer)
        self.optimizer.load_state_dict(state["optimizer"])
        with torch.no_grad():
            for name, acc in self.sparse_accums.items():
                acc.copy_(state["sparse_accums"][name])
        self.step = int(state["step"])
        self._weights_loaded = True

    def enable_step_checkpointing(self, directory: str, every_n_steps: int = 100, max_to_keep: int = 3):
        """Checkpoint the full train state every N steps (``maybe_step_checkpoint``); resume by ``maybe_resume``."""
        from ..utils.checkpoint import TrainCheckpointer

        self._ckpt = TrainCheckpointer(directory, max_to_keep=max_to_keep)
        self._ckpt_every = every_n_steps
        return self._ckpt

    def maybe_step_checkpoint(self):
        """Save the train state when step checkpoints are on and ``step`` is a positive multiple of ``every_n_steps``."""
        if self._ckpt is not None and self.step > 0 and self.step % self._ckpt_every == 0:
            state = self.train_state()  # a collective under a mesh: every rank gathers
            if self._writes():
                self._ckpt.save(self.step, state)
            if self.mesh is not None:
                torch.distributed.barrier()  # no rank reads the step before it is written

    def maybe_resume(self) -> Optional[int]:
        """Restore the latest step checkpoint into this trainer; returns the resumed step, or None."""
        if self._ckpt is None:
            return None
        restored, step = self._ckpt.restore(self.train_state())
        if step is not None:
            self.load_train_state(restored)
            print(f"resumed from step checkpoint {step}")
        return step

    # -- export / visualization ------------------------------------------------
    def _require_state(self, what: str) -> None:
        if self.step == 0 and not self._weights_loaded:
            raise RuntimeError(f"{what}() requires a trained/initialized model — call fit() first")

    def export(self, output_path: str, example_input=None, mode: Optional[str] = None) -> str:
        """``torch.export`` of the trained model's forward (``mode`` ``"user"`` / ``"item"``: one tower) at the
        example's shapes, saved to ``<output_path>.pt2`` (``utils/export.py``); the example is
        ``generate_dummy_input(model)`` when not given."""
        self._require_state("export")
        self._check_no_mesh("export")
        from ..utils.export import TorchExporter
        from ..utils.model_utils import generate_dummy_input

        if example_input is None:
            example_input = generate_dummy_input(self.model)
        return TorchExporter(self.model).export(output_path, example_input, mode=mode)

    def export_quantized(self, output_path: str, example_input=None, mode: Optional[str] = None, quant_mode: str = "int8") -> str:
        """The same export with int8 (per-channel scales) or fp16 weights, dequantized inside the program."""
        self._require_state("export_quantized")
        self._check_no_mesh("export_quantized")
        from ..utils.export import TorchExporter
        from ..utils.model_utils import generate_dummy_input

        if example_input is None:
            example_input = generate_dummy_input(self.model)
        return TorchExporter(self.model).export_quantized(output_path, example_input, mode=mode, quant_mode=quant_mode)

    def visualization(self, x=None, save_path: Optional[str] = None) -> str:
        """The model's summary (``utils/model_utils.model_summary``): a row per parameter, the totals and the
        forward's FLOPs on ``x`` (``generate_dummy_input(model)`` when not given); written to ``save_path`` too."""
        from ..utils.model_utils import generate_dummy_input, model_summary

        if x is None:
            x = generate_dummy_input(self.model)
        summary = model_summary(self.model, x=x)
        if save_path:
            os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
            with open(save_path, "w") as f:
                f.write(summary)
        print(summary)
        return summary

    def model_state(self) -> Dict[str, torch.Tensor]:
        """The model's ``state_dict``, unsharded under a mesh (a collective: every rank calls it)."""
        state = self.model.state_dict()
        if self.mesh is None:
            return state
        params = dict(self.model.named_parameters())
        return {k: mesh_lib.unshard(v, params[k]) if k in params else v for k, v in state.items()}

    def save(self, name: str = "model.pt") -> str:
        os.makedirs(self.model_path or ".", exist_ok=True)
        target = os.path.join(self.model_path or ".", name)
        state = self.model_state()
        if self._writes():
            torch.save(state, target)
        if self.mesh is not None:
            torch.distributed.barrier()
        return target

    def load_weights(self, target: str) -> None:
        """Load the ``state_dict`` file ``target`` into the model (under a mesh, this rank's rows of each row shard)."""
        state = torch.load(target, map_location=self.device, weights_only=True)
        if self.mesh is not None:
            params = dict(self.model.named_parameters())
            state = {k: mesh_lib.reshard(v, params[k]) if k in params else v for k, v in state.items()}
        check_table_rows(state, self.model.state_dict(), target)
        self.model.load_state_dict(state)

    def load(self, name: str = "model.pt") -> torch.nn.Module:
        self.load_weights(self.model_path if os.path.isfile(self.model_path) else os.path.join(self.model_path, name))
        self._weights_loaded = True
        return self.model


class DictBatchTrainer(TorchTrainer):
    """The loop of the trainers whose batches are dicts of arrays (``CTRTrainer``, ``MatchTrainer``): ``loss_fn(x,
    y, w)`` of a padded batch, ``evaluate(model, loader)`` for early stopping, ``hyperparams`` for the loggers.

    Host batches are padded to the loader's ``batch_size`` by cycling their
    rows and weighed 0 there; ``steps_per_call`` of them stack into a group,
    which runs as that many single steps (the JAX package's scan equals it).
    A loader with ``device_groups`` (``DeviceCachedLoader``) hands its groups
    over on the device.  Labels keep their dtype unless ``label_dtype``
    says otherwise.
    """

    label_dtype = None
    checkpoint_in_loop = False  # maybe_step_checkpoint after each group (CTRTrainer's loop, as in the JAX package)

    @property
    def hyperparams(self) -> Dict:
        return {}

    def _to_device(self, x, *arrays):
        put = lambda a: torch.as_tensor(np.asarray(a), device=self.device)  # noqa: E731
        return ({k: put(v) for k, v in x.items()},) + tuple(put(a) for a in arrays)

    def _iter_groups(self, data_loader):
        """Padded host batches stacked ``steps_per_call`` at a time, as ``(n, batch, ...)`` numpy arrays."""
        batch_size = data_loader.batch_size
        pending = []

        def stacked():
            xs = {k: np.stack([b[0][k] for b in pending]) for k in pending[0][0]}
            ys = np.stack([b[1] for b in pending])
            ws = np.stack([b[2] for b in pending])
            return xs, ys if self.label_dtype is None else ys.astype(self.label_dtype), ws

        for x, y in data_loader:
            pending.append(pad_batch(x, y, batch_size))
            if len(pending) >= max(1, self.steps_per_call):
                yield stacked()
                pending = []
        if pending:
            yield stacked()

    def _groups(self, data_loader):
        """The loader's groups on the device: a ``DeviceCachedLoader``'s own, else the host groups copied two
        groups ahead of the step (``data/dataset.py`` ``prefetch_to_device``).  Under a mesh, this rank's rows
        of each group."""
        sharding = mesh_lib.scan_batch_sharding(self.mesh)
        if hasattr(data_loader, "device_groups"):
            groups = data_loader.device_groups()
            return groups if sharding is None else (({k: sharding.local(v) for k, v in xs.items()}, None if ys is None else sharding.local(ys), sharding.local(ws)) for xs, ys, ws in groups)
        from ..data.dataset import prefetch_to_device

        return prefetch_to_device(self._iter_groups(data_loader), size=2, sharding=sharding, device=self.device)

    def train_one_epoch(self, data_loader, log_interval: int = 10, lr: Optional[float] = None) -> float:
        """One pass over ``data_loader``; returns the mean step loss (one host read at the end)."""
        self.set_lr(self.lr0 if lr is None else lr)
        losses = []
        n_seen = 0
        t0 = time.perf_counter()
        for gi, (xs, ys, ws) in enumerate(self._groups(data_loader)):
            for s in range(ws.shape[0]):  # a group of n batches runs as n single steps
                losses.append(self.train_step({k: v[s] for k, v in xs.items()}, None if ys is None else ys[s], ws[s]))
            n_seen += int(ws.shape[0]) * int(ws.shape[1])
            if self.checkpoint_in_loop:
                self.maybe_step_checkpoint()
            if log_interval and (gi + 1) % log_interval == 0:
                print(f"  train {n_seen} examples, loss {float(torch.stack(losses[-ws.shape[0]:]).mean()):.5f}, {n_seen / (time.perf_counter() - t0):,.0f} ex/s")
        return float(to_numpy(torch.stack(losses)).mean()) if losses else 0.0

    def fit(self, train_dataloader, val_dataloader=None, log_interval: int = 10):
        """Epochs under StepLR, early stopping on the validation AUC (the best weights restored), then a checkpoint."""
        for logger in iter_loggers(self.loggers):
            logger.log_hyperparams({"n_epoch": self.n_epoch, "learning_rate": self.lr0, **self.hyperparams})
        for epoch_i in range(self.n_epoch):
            lr = self.epoch_lr(epoch_i)
            t0 = time.perf_counter()
            train_loss = self.train_one_epoch(train_dataloader, log_interval, lr=lr)
            print(f"epoch: {epoch_i} train loss: {train_loss:.5f} ({time.perf_counter() - t0:.2f}s, lr={lr:g})")
            for logger in iter_loggers(self.loggers):
                logger.log_metrics({"train/loss": train_loss, "learning_rate": lr}, step=epoch_i)
            if val_dataloader:
                auc = self.evaluate(self.model, val_dataloader)
                print(f"epoch: {epoch_i} validation auc: {auc:.5f}")
                for logger in iter_loggers(self.loggers):
                    logger.log_metrics({"val/auc": auc}, step=epoch_i)
                # the state_dict holds the BatchNorm running statistics too
                weights = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
                if self.early_stopper.stop_training(auc, weights):
                    print(f"validation: best auc: {self.early_stopper.best_auc}")
                    break
        if val_dataloader and self.early_stopper.best_weights is not None:
            self.model.load_state_dict(self.early_stopper.best_weights)
        self.save()
        for logger in iter_loggers(self.loggers):
            logger.finish()


def check_optimizer_state(state: Dict, optimizer) -> None:
    """Raise a ``ValueError`` naming every per-parameter state tensor of an optimizer ``state_dict`` whose shape is
    not its parameter's in ``optimizer`` (scalars such as Adam's ``step`` aside)."""
    parts = getattr(optimizer, "optimizers", [optimizer])
    dicts = state["optimizers"] if isinstance(optimizer, SplitOptimizer) else [state]
    problems = []
    for i, (opt, sd) in enumerate(zip(parts, dicts)):
        params = [p for group in opt.param_groups for p in group["params"]]
        for idx, values in sd["state"].items():
            if int(idx) >= len(params):
                problems.append(f"optimizer {i} parameter {idx}: this optimizer has {len(params)} parameters")
                continue
            shape = params[int(idx)].shape
            problems += [f"optimizer {i} parameter {idx} {key}: checkpoint {tuple(v.shape)} vs parameter {tuple(shape)}"
                         for key, v in values.items() if isinstance(v, torch.Tensor) and v.ndim and v.shape != shape]
    if problems:
        raise ValueError("the optimizer state does not fit this trainer's parameters: " + "; ".join(problems))


def check_table_rows(restored: Dict[str, torch.Tensor], template: Dict[str, torch.Tensor], target: str) -> None:
    """Raise a ``ValueError`` naming every embedding table whose ROW count in
    a checkpoint differs from the model's (same width).

    The usual cause: a checkpoint saved before tables of at least 65,536
    rows were padded to a multiple of 64 rows.
    """
    mismatched = {
        k: (tuple(restored[k].shape), tuple(template[k].shape))
        for k in restored.keys() & template.keys()
        if k.endswith(("_table", "_embedding")) and restored[k].shape != template[k].shape and restored[k].shape[1:] == template[k].shape[1:]
    }
    if mismatched:
        detail = ", ".join(f"{k}: checkpoint {c} vs model {t}" for k, (c, t) in sorted(mismatched.items()))
        raise ValueError(
            f"checkpoint {target!r} has embedding tables whose ROW counts differ from the "
            f"model's ({detail}). Tables >= 65536 rows are padded to a 64-row multiple (padded "
            f"rows are zero and take no gradient); a checkpoint saved before that padding cannot "
            f"load directly. Rebuild the model at the checkpoint's shapes, or pad / slice the "
            f"restored table rows to the model's and save again."
        )
