"""RQVAETrainer: trains an ``RQVAEModel`` on item embeddings and gives the items semantic ids.

Counterpart of ``torch_rechub_tpu/trainers/rqvae_trainer.py``.  Before the
first step the codebooks take their k-means init from the first 8,192
rows (``kmeans_init``).  A step is the reconstruction loss (MSE or L1)
plus ``quant_loss_weight`` times the quantizers' loss, through Adam.
``fit`` shuffles the rows each epoch with numpy's ``default_rng(seed +
epoch)`` (the JAX package's order) and drops the last partial batch,
raises on a non-finite epoch loss, keeps the best-loss checkpoint
(``best_loss_model.pt``) and every ``eval_step`` epochs the
best-collision-rate one (``best_collision_model.pt``), then saves
``model.pt`` (``state_dict``s, as the other trainers save).

``generate_semantic_ids`` codes every item by the nearest codes, then
re-codes the colliding groups' last stage with Sinkhorn, up to
``max_retries`` passes.  The passes are deterministic, so once a pass
changes no code the later ones would repeat it and are not run.  At the
retry epsilon of 0.003 the reference's Sinkhorn overflows and gives code 0
(``models/generative/rqvae.py``), which the port keeps.

``mesh=`` trains over a (data, model) mesh of ranks (``trainers/base.py``):
every rank holds the same data and computes the same k-means codebooks on
the host, which are then checked equal across the ranks; each rank steps on
its rows of every global batch, inside the ``data_parallel`` scope where the
losses, BatchNorm's statistics and Sinkhorn's sums are the global batch's,
and the gradients are summed over the data group.  The model has no table
that shards, so the model axis replicates it.  ``evaluate`` and
``generate_semantic_ids`` run the whole data on every rank, which must all
call them.
"""

from __future__ import annotations

import collections
import time
from typing import Optional

import numpy as np
import torch

from ..basic.tracking import iter_loggers
from ..models.generative.rqvae import RQVAEModel, kmeans_init_codebooks
from ..parallel import distributed as pdist
from ..parallel.mesh import shard_batch
from .base import TorchTrainer, to_numpy


class RQVAETrainer(TorchTrainer):
    """Trains ``model`` on ``device``: the CUDA card unless the caller passes another (``device="cpu"``);
    with no card and no device it raises.  ``mesh`` takes a ``parallel.mesh.DeviceMesh``."""

    def __init__(self, model: RQVAEModel, optimizer_params=None, scheduler_params=None, n_epoch: int = 100, eval_step: int = 5, model_path: str = "./", use_sk: bool = True, model_logger=None, mesh=None, seed: int = 0, device=None):
        super().__init__(model, optimizer_params, scheduler_params, n_epoch, 10, model_path, seed, model_logger, device, mesh=mesh)
        self.eval_step = eval_step
        self.use_sk = use_sk
        self.best_loss = np.inf
        self.best_collision_rate = np.inf
        self.initialised = False

    def init_state_from_data(self, data: np.ndarray) -> None:
        """The codebooks' k-means init from the first 8,192 rows, once, where the model asks for it."""
        if self.model.kmeans_init:
            kmeans_init_codebooks(self.model, np.asarray(data[: min(len(data), 8192)]), num_iters=self.model.kmeans_iters, seed=self.seed)
            if self.mesh is not None:
                self._check_codebooks_agree()
        self.initialised = True

    def _check_codebooks_agree(self) -> None:
        """Raise on every rank unless every rank's k-means codebooks equal rank 0's bit for bit."""
        books = torch.cat([getattr(self.model.rq, f"vq_layers_{i}").embedding.detach().reshape(-1) for i in range(self.model.rq.n_stages)])
        first = pdist.broadcast_(books.clone(), int(self.mesh.devices.flat[0]))
        differ = pdist.all_reduce(torch.tensor([0.0 if torch.equal(books, first) else 1.0], device=books.device), None)
        if float(differ) > 0:
            raise RuntimeError(f"the k-means codebooks differ between the ranks ({int(differ)} of {self.mesh.size} differ from rank 0's): every rank must fit on the same data")

    def loss_fn(self, x: torch.Tensor) -> torch.Tensor:
        """The training loss of a batch of rows (the model in train mode): the reconstruction plus the quantizers'."""
        out, rq_loss, _ = self.model(x, use_sk=self.use_sk, generator=self.generator)
        return self.model.compute_loss(out, rq_loss, x)[0]

    def _iter_batches(self, data: np.ndarray, batch_size: int, shuffle: bool = True, epoch: int = 0):
        n = len(data)
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        for s in range(0, n - batch_size + 1, batch_size):
            yield data[order[s:s + batch_size]]

    def train_one_epoch(self, data: np.ndarray, batch_size: int = 1024, epoch: int = 0) -> float:
        """One shuffled pass over ``data`` (the last partial batch dropped); the mean step loss (one host read).
        Under a mesh each step takes this rank's rows of the batch."""
        losses = [self.train_step(torch.as_tensor(shard_batch(xb, self.mesh), device=self.device)) for xb in self._iter_batches(data, batch_size, epoch=epoch)]
        return float(to_numpy(torch.stack(losses)).mean()) if losses else 0.0

    def fit(self, data, batch_size: int = 1024):
        """Train on an ``(N, in_dim)`` embedding matrix; returns ``(best loss, best collision rate)``."""
        data = np.asarray(data, dtype=np.float32)
        if not self.initialised:
            self.init_state_from_data(data)
        for logger in iter_loggers(self.loggers):
            logger.log_hyperparams({"n_epoch": self.n_epoch, "learning_rate": self.lr0})
        for epoch_i in range(self.n_epoch):
            self.set_lr(self.epoch_lr(epoch_i))
            t0 = time.perf_counter()
            epoch_loss = self.train_one_epoch(data, batch_size, epoch_i)
            if not np.isfinite(epoch_loss):
                raise ValueError(f"Loss is {epoch_loss} at epoch {epoch_i}; training diverged.")
            print(f"epoch: {epoch_i} loss: {epoch_loss:.6f} ({time.perf_counter() - t0:.2f}s)")
            for logger in iter_loggers(self.loggers):
                logger.log_metrics({"train/loss": epoch_loss}, step=epoch_i)
            if epoch_loss < self.best_loss:
                self.best_loss = epoch_loss
                self.save("best_loss_model.pt")
            if (epoch_i + 1) % self.eval_step == 0:
                rate = self.evaluate(data, batch_size)
                print(f"epoch: {epoch_i} collision rate: {rate:.6f}")
                for logger in iter_loggers(self.loggers):
                    logger.log_metrics({"val/collision_rate": rate}, step=epoch_i)
                if rate < self.best_collision_rate:
                    self.best_collision_rate = rate
                    self.save("best_collision_model.pt")
        self.save()
        for logger in iter_loggers(self.loggers):
            logger.finish()
        return self.best_loss, self.best_collision_rate

    def evaluate(self, data, batch_size: int = 1024) -> float:
        """The semantic-id collision rate over the dataset (nearest codes)."""
        strs = [str(list(row)) for row in self._indices(data, batch_size, use_sk=False)]
        return (len(strs) - len(set(strs))) / max(len(strs), 1)

    @torch.inference_mode()
    def _indices(self, data, batch_size: int, use_sk: bool, sk_epsilon_overrides=None) -> np.ndarray:
        """``(N, n_stages)`` codes of ``data`` in batches of ``batch_size`` (one host read at the end)."""
        self.model.eval()
        out = [self.model.get_indices(torch.as_tensor(np.asarray(data[s:s + batch_size], dtype=np.float32), device=self.device), use_sk=use_sk, sk_epsilon_overrides=sk_epsilon_overrides)
               for s in range(0, len(data), batch_size)]
        return to_numpy(torch.cat(out))

    def generate_semantic_ids(self, data, batch_size: int = 1024, prefix=("<a_{}>", "<b_{}>", "<c_{}>", "<d_{}>", "<e_{}>"), max_retries: int = 20):
        """``{item: [code strings]}`` for every row of ``data``, collisions re-coded at the last stage by Sinkhorn."""
        n_stages = len(self.model.num_emb_list)
        if len(prefix) < n_stages:
            raise ValueError("The length of prefix should be no less than that of num_emb_list")
        data = np.asarray(data, dtype=np.float32)
        sids = self._indices(data, batch_size, use_sk=False)
        codes = [[prefix[i].format(int(v)) for i, v in enumerate(row)] for row in sids]
        code_strs = [str(c) for c in codes]

        # collision retry: re-assign only the last stage with Sinkhorn
        last_eps = self.model.sk_epsilons[-1] if self.model.sk_epsilons and self.model.sk_epsilons[-1] > 0 else 0.003
        overrides = tuple([0.0] * (n_stages - 1) + [last_eps])
        self.retry_passes = 0
        for _ in range(max_retries):
            groups = collections.defaultdict(list)
            for i, cs in enumerate(code_strs):
                groups[cs].append(i)
            collisions = [idxs for idxs in groups.values() if len(idxs) > 1]
            if not collisions:
                break
            before = list(code_strs)
            for items in collisions:
                idx = self._indices(data[np.asarray(items)], batch_size, use_sk=True, sk_epsilon_overrides=overrides)
                for item, row in zip(items, idx):
                    codes[item] = [prefix[i].format(int(v)) for i, v in enumerate(row)]
                    code_strs[item] = str(codes[item])
            self.retry_passes += 1
            if code_strs == before:  # a fixed point: every later pass would give these codes again
                break
        counts = collections.Counter(code_strs)
        rate = (len(code_strs) - len(set(code_strs))) / max(len(code_strs), 1)
        print(f"All indices number: {len(codes)}; max conflicts: {max(counts.values())}; collision rate: {rate:.6f}")
        return {i: list(c) for i, c in enumerate(codes)}
