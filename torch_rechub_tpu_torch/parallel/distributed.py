"""Process groups, the collectives of the (data, model) mesh, and a launcher.

Counterpart of ``torch_rechub_tpu/parallel/distributed.py``.  In JAX one
program drives every device of a host and XLA inserts the collectives; in
PyTorch one process drives one device (a "rank"), so the port brings the
ranks up itself and names every collective:

1. every rank calls :func:`initialize` (``torch.distributed.init_process_group``;
   under ``torchrun`` the address, world size and rank come from its
   environment), or :func:`spawn` starts the ranks and does it for them;
2. ``parallel.mesh.create_mesh(data, model)`` lays the world's ranks out on
   the grid, rank ``d * model + m``;
3. every rank reads the same global batch and keeps its data index's rows
   (``parallel.mesh.shard_batch``); the trainers do this themselves.

Backend: ``nccl`` when every rank has a card of its own, ``gloo`` otherwise
(the CPU, or several ranks sharing one card, which NCCL refuses).  gloo's
collectives on CUDA tensors are staged through host memory
(:func:`host_staged`): one copy to the host, the collective, one copy back.

The collectives' gradients follow one rule.  Over the ``data`` axis each rank
holds a part of one global computation, and the losses are global means
(:func:`mean_over_data`): their value is the global loss on every rank, their
gradient this rank's share, and the shares add up over the data group, where
the trainers all-reduce the gradients.  Over the ``model`` axis the ranks of
a group hold the same rows and compute the same values, except on a row
shard's parts: a part's sum or concatenation (:func:`sum_replicated`,
:func:`gather_replicated`) takes this rank's part of the replicated output's
gradient, and a replicated tensor entering the parts
(:func:`replicated_input`) sums their gradients over the group.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import shutil
import tempfile
import threading
import time
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.profiling import annotate, count


def default_backend(num_processes: int) -> str:
    """``"nccl"`` when every one of ``num_processes`` ranks of this host can have a card of its own, else ``"gloo"``."""
    return "nccl" if torch.cuda.is_available() and torch.cuda.device_count() >= num_processes else "gloo"


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None, process_id: Optional[int] = None, backend: Optional[str] = None, timeout_s: float = 600.0):
    """Bring up the process group (a no-op if it is up already).

    ``coordinator_address`` is ``host:port`` (a ``tcp://`` store there) or an
    ``init_method`` URL (``tcp://...``, ``file://...``); with it,
    ``num_processes`` and ``process_id`` are the world size and this rank.
    Without it, ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``) is read; where there is none the process goes on alone,
    with a warning, as the JAX package does.  An explicit configuration that
    fails raises.  Under ``nccl`` the rank takes the card ``process_id %
    device_count``.
    """
    if dist.is_initialized():
        return
    if coordinator_address is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            warnings.warn("torch.distributed: no coordinator address and no torchrun environment; continuing single-process", RuntimeWarning, stacklevel=2)
            return
        num_processes, process_id, init_method = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]), "env://"
    else:
        if num_processes is None or process_id is None:
            raise ValueError("initialize(coordinator_address=...) needs num_processes and process_id")
        init_method = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    backend = backend or default_backend(num_processes)
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    try:
        dist.init_process_group(backend, init_method=init_method, world_size=num_processes, rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    except (RuntimeError, ValueError) as e:
        raise RuntimeError(f"torch.distributed.init_process_group failed for {init_method!r} (rank {process_id} of {num_processes}, {backend}): {e}") from e


def process_info() -> Dict[str, int]:
    """This process's rank and the world's size; a process drives one device."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return {"process_index": dist.get_rank() if dist.is_initialized() else 0, "process_count": world, "local_devices": 1, "global_devices": world}


def host_batch_slice(global_batch_size: int) -> slice:
    """This process's contiguous row range of a global batch."""
    info = process_info()
    per_host = global_batch_size // info["process_count"]
    start = info["process_index"] * per_host
    return slice(start, start + per_host)


def global_batch_from_host(host_batch: Dict[str, np.ndarray], mesh, axis: str = "data") -> Dict[str, np.ndarray]:
    """The global batch from each rank's LOCAL rows: the ranks of ``mesh``'s ``axis`` group pass their rows, in
    that axis's order, and every rank gets them concatenated (numpy), ready for a trainer's loader."""
    group = mesh.group(axis)
    device = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend(group) == "nccl" else torch.device("cpu")
    return {k: all_gather(torch.as_tensor(np.ascontiguousarray(v), device=device), group).cpu().numpy() for k, v in host_batch.items()}


def global_batch_seed(base_seed: int, step: int) -> int:
    """Deterministic per-step seed identical on every host (global-batch shuffling)."""
    return (base_seed * 1000003 + step) % (2**31 - 1)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def host_staged(tensor: torch.Tensor, group) -> bool:
    """Whether a collective on ``tensor`` over ``group`` goes through host memory: gloo on a CUDA tensor."""
    return tensor.is_cuda and dist.get_backend(group) == "gloo"


def group_size(group) -> int:
    return dist.get_world_size(group)


def _counted(tensor: torch.Tensor) -> None:
    count("rechub.dist.calls")
    count("rechub.dist.bytes", tensor.numel() * tensor.element_size())


def all_reduce(tensor: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of ``tensor`` over ``group`` (a new tensor; the input is left as it is)."""
    _counted(tensor)
    out = tensor.detach().to("cpu" if host_staged(tensor, group) else tensor.device, copy=True).contiguous()
    dist.all_reduce(out, op=op, group=group)
    return out.to(tensor.device)


def all_gather(tensor: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim``, in the group's rank order (span ``rechub.dist.all_gather``)."""
    _counted(tensor)
    with annotate("rechub.dist.all_gather"):
        src = tensor.detach().movedim(dim, 0).contiguous()
        if host_staged(src, group):
            src = src.cpu()
        out = torch.empty((group_size(group) * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype, device=src.device)
        dist.all_gather_into_tensor(out, src, group=group)
        return out.to(tensor.device).movedim(0, dim)


def broadcast_(tensor: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``tensor`` overwritten in place with global rank ``src``'s."""
    if host_staged(tensor, group):
        host = tensor.detach().cpu()
        dist.broadcast(host, src=src, group=group)
        with torch.no_grad():
            tensor.copy_(host)
    else:
        dist.broadcast(tensor.data, src=src, group=group)
    return tensor


def _own_block(grad: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, r = group_size(group), dist.get_rank(group)
    size = grad.shape[dim] // n
    return grad.narrow(dim, r * size, size).contiguous()


class _ReplicatedInput(torch.autograd.Function):
    """A tensor every rank of a group holds alike, entering computations that differ by rank: the identity, whose
    gradient is the group's sum of theirs."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


class _SumReplicated(torch.autograd.Function):
    """Sum over a group whose ranks then compute the same values: the gradient is the output's, as it is."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherReplicated(torch.autograd.Function):
    """Concatenation over a group whose ranks then compute the same values: the gradient is this rank's block."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _own_block(grad, ctx.group, ctx.dim), None, None


def replicated_input(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (alike on every rank of ``group``) as the input of per-rank parts (a row shard's vocab columns): the
    gradient sums over the group."""
    return _ReplicatedInput.apply(x, group)


def sum_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum over ``group`` for a consumer that every rank of the group computes alike (the model axis)."""
    return _SumReplicated.apply(x, group)


def gather_replicated(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Differentiable concatenation along ``dim`` over ``group``, for a consumer every rank computes alike."""
    return _GatherReplicated.apply(x, group, dim)


def sum_partitioned(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum over ``group`` for consumers that differ by rank (BatchNorm's statistics over the data
    axis): the gradient is the group's sum of theirs."""
    return replicated_input(sum_replicated(x, group), group)


def gather_partitioned(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable concatenation of rows over ``group`` for consumers that differ by rank (the item tower of the
    global in-batch pool): the gradient is this rank's block of the group's sum of theirs."""
    return replicated_input(gather_replicated(x, group), group)


# ---------------------------------------------------------------------------
# the data-parallel scope of a training step
# ---------------------------------------------------------------------------

_STATE = threading.local()


@contextlib.contextmanager
def data_parallel(mesh):
    """Inside, the losses are means over the global batch (:func:`mean_over_data`) and BatchNorm's statistics
    are the global batch's; ``mesh=None`` changes nothing.  The trainers open it around a step's loss."""
    prev = getattr(_STATE, "mesh", None)
    _STATE.mesh = mesh
    try:
        yield
    finally:
        _STATE.mesh = prev


def data_group():
    """The data group of the open :func:`data_parallel` scope, or None outside one."""
    mesh = getattr(_STATE, "mesh", None)
    return None if mesh is None else mesh.data_group


def global_mean(num: torch.Tensor, den: torch.Tensor, group, floor: float) -> torch.Tensor:
    """``Σ num / max(Σ den, floor)`` over ``group``: the global value on every rank, with the gradient of this
    rank's share ``num / max(Σ den, floor)``; the shares' gradients add up to the global one."""
    total = torch.clamp_min(all_reduce(den, group), floor)
    share = num / total
    return all_reduce(num, group) / total + (share - share.detach())


def mean_over_data(num: torch.Tensor, den: torch.Tensor, floor: float) -> torch.Tensor:
    """``num / max(den, floor)``, or inside a :func:`data_parallel` scope the global batch's mean (:func:`global_mean`)."""
    group = data_group()
    if group is None:
        return num / torch.clamp_min(den, floor)
    return global_mean(num, den, group, floor)


def mean_over_batch(x: torch.Tensor) -> torch.Tensor:
    """``x.mean()``, or inside a :func:`data_parallel` scope the mean over the global batch, of which ``x`` holds
    this rank's rows (:func:`global_mean`)."""
    if data_group() is None:
        return x.mean()
    return mean_over_data(x.sum(), torch.tensor(float(x.numel()), device=x.device), 1.0)


def sum_tensors(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Each of ``tensors`` summed over ``group`` (new tensors, in order), one flat buffer per dtype."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = all_reduce(torch.cat([tensors[i].reshape(-1) for i in idx]), group)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view_as(tensors[i])
    return out


def all_reduce_gradients(parameters: Sequence[torch.Tensor], group) -> None:
    """Sum the ``.grad`` of ``parameters`` over ``group`` in place, one flat buffer per dtype (span
    ``rechub.dist.all_reduce``)."""
    with annotate("rechub.dist.all_reduce"):
        grads = [p.grad for p in parameters if p.grad is not None]
        for g, total in zip(grads, sum_tensors(grads, group)):
            g.copy_(total)


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------


def _rank_main(fn, rank: int, nprocs: int, init_method: str, backend: Optional[str], args):
    initialize(init_method, nprocs, rank, backend)
    try:
        return fn(rank, *args)
    finally:
        if dist.is_initialized():  # an aborted group (``_abort_if_a_rank_fails``) is gone already
            dist.destroy_process_group()


def _abort_if_a_rank_fails(procs, done: threading.Event) -> None:
    """Aborts this process's groups 5 s after one of ``procs`` failed, unless ``done`` is set by then: a collective
    of this process that waits on the failed rank then raises instead of waiting for the group's timeout."""
    while not done.wait(0.2):
        if any(p.exitcode not in (None, 0) for p in procs) and not done.wait(5.0):
            if dist.is_initialized():
                dist.distributed_c10d._abort_process_group()
            return


def spawn(fn, nprocs: int, args=(), backend: Optional[str] = None, timeout_s: float = 600.0, here: Optional[int] = None):
    """Run ``fn(rank, *args)`` in ``nprocs`` processes started by ``spawn``, each with the process group up.

    The rendezvous is a file in a fresh temporary directory (no port to
    collide with).  Raises a ``RuntimeError`` naming the ranks that failed,
    or that were still running after ``timeout_s`` seconds, or 5 seconds
    after another rank failed (they are killed).  ``fn`` must be importable by name (a module-level function).

    ``here``: the rank that runs in the calling process instead of a new one
    (its process group is up while ``fn`` runs and destroyed after); ``spawn``
    then returns what ``fn`` returned there.  If ``fn`` raises there, the
    other ranks are killed and the error propagates.  If another rank fails
    while ``fn`` runs there, the calling process's groups are aborted 5
    seconds later, so that a collective waiting on that rank raises there
    (gloo raises by itself when a peer's connection closes); a group that is
    not up yet raises after :func:`initialize`'s timeout.
    """
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    rdzv = tempfile.mkdtemp(prefix="rechub_rdzv_")
    result = None
    try:
        store = f"file://{os.path.join(rdzv, 'store')}"
        procs = [ctx.Process(target=_rank_main, args=(fn, r, nprocs, store, backend, tuple(args)), daemon=False) for r in range(nprocs) if r != here]
        for p in procs:
            p.start()
        if here is not None:
            done = threading.Event()
            watchdog = threading.Thread(target=_abort_if_a_rank_fails, args=(procs, done), daemon=True)
            watchdog.start()
            try:
                result = _rank_main(fn, here, nprocs, store, backend, args)
            except BaseException:
                for p in procs:
                    p.kill()
                raise
            finally:
                done.set()
                watchdog.join()
        deadline = time.monotonic() + timeout_s
        # wait for all; stop early when one rank failed, as the others may wait on it forever
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline and not any(p.exitcode not in (None, 0) for p in procs):
            time.sleep(0.05)
        if time.monotonic() < deadline:  # a rank failed: the others' exits, for a few seconds, before they are killed
            grace = time.monotonic() + 5.0
            for p in procs:
                p.join(timeout=max(0.0, grace - time.monotonic()))
        ranks = [r for r in range(nprocs) if r != here]
        hung = [r for r, p in zip(ranks, procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
        failed = {r: p.exitcode for r, p in zip(ranks, procs) if p.exitcode not in (0, None) and r not in hung}
        if hung or failed:
            raise RuntimeError(f"spawn({getattr(fn, '__name__', fn)}): ranks failed {failed}, ranks killed {hung} (after {timeout_s:.0f} s or after another rank failed)")
    finally:
        shutil.rmtree(rdzv, ignore_errors=True)
    return result
