"""The trainer's step on the card as CUDA graphs: captured once for each signature, then replayed.

An eager step issues every kernel of the forward, the backward, Adam and
the sparse update from Python and autograd, some hundreds of launches, and
on a small model the card waits for them.  A replay of a CUDA graph issues
the same kernels, the port's own among them, in one call.

``TorchTrainer.train_step`` hands its step here on a CUDA device without a
mesh, where :class:`StepGraphs` decides from what it can observe:

- The step's signature (:func:`signature`): the shape, dtype and device of
  every tensor of the batch (dicts in their key order, with the keys), the
  value of every other leaf of it, the learning rates, the precision,
  which parameters take a gradient, and the switches that choose kernels
  (TF32, deterministic algorithms, the attention's fused or split
  backward).  Everything a capture bakes in is in it.
- A signature's first step runs eagerly on a side stream (the warm-up:
  Adam's state, cuBLAS's workspaces and the kernels' builds exist before a
  capture).  Its second step, if the step before had the same signature,
  captures two graphs, forward with loss, backward and dense optimizer,
  and the sparse update, into one memory pool, and replays them; later
  steps replay them.  Each replay first copies the batch into the graphs'
  inputs on the device, and returns a copy of the step's loss.
- At most :data:`MAX_GRAPHS` signatures hold graphs; the least recently
  used is dropped beyond them.  :meth:`StepGraphs.drop` drops them all
  (the trainer does so when its state is loaded).
- A model whose modules declare ``graph_safe = False`` (``basic/moe.py``'s
  expert layer, which reads its per-expert counts on the host) runs every
  step eagerly, counted as ``rechub.train.graph.eager``: no capture is tried.
- A capture that fails (a read of the device by the host, a copy from
  pageable host memory, a shape that depends on the data, an unregistered
  generator) leaves nothing behind: the step runs eagerly, and so does
  every later step of that signature.  A capture that made optimizer
  state is refused too, since each replay would make it anew.

What the replays keep: the random draws come from the trainer's CUDA
generators, registered with the graph, so each replay draws what the eager
step would have drawn; each parameter's ``.grad`` reads the step's
gradient after a replay; the port's kernel launch counters advance by the
launches the capture counted (``ops/cuda/__init__.py``).  A value the step
reads on the host and that changes from step to step without being in the
signature (a Python random number, a counter) would be baked in: the
trainers' losses read none.
"""

from __future__ import annotations

import collections
import warnings
from typing import List, Optional, Tuple

import torch

from ..ops.cuda import add_launch_counts, kernel_switches, launch_counts
from ..utils.profiling import annotate, count

MAX_GRAPHS = 4  # signatures whose graphs are held at once
MAX_REFUSED = 64  # signatures remembered as not capturable


def _leaves(x, key: list, tensors: list) -> None:
    if isinstance(x, torch.Tensor):
        key.append((tuple(x.shape), x.dtype, x.device))
        tensors.append(x)
    elif type(x) is dict:
        key.append(("dict", tuple(x)))
        for v in x.values():
            _leaves(v, key, tensors)
    elif type(x) in (list, tuple):
        key.append((type(x).__name__, len(x)))
        for v in x:
            _leaves(v, key, tensors)
    elif x is None or isinstance(x, (bool, int, float, str)):
        key.append((type(x).__name__, x))  # a capture bakes its value in
    else:
        raise TypeError(f"a batch leaf of type {type(x).__name__}")


def signature(batch, trainer) -> Tuple[tuple, List[torch.Tensor]]:
    """``(key, tensors)``: the key of the step's graphs and the batch's tensors in the key's order; a
    ``TypeError`` where the batch holds something other than tensors, None, numbers, strings and plain lists, tuples
    and dicts (the step then stays eager)."""
    key, tensors = [], []
    _leaves(batch, key, tensors)
    params = [p for group in trainer.optimizer.param_groups for p in group["params"]]
    key += [trainer.lr, tuple(group["lr"] for group in trainer.optimizer.param_groups), trainer.precision, tuple(p.requires_grad for p in params),
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, torch.are_deterministic_algorithms_enabled(), kernel_switches()]
    return tuple(key), tensors


def _rebuild(x, tensors):
    """``x`` with its tensors replaced, in :func:`signature`'s order, by the next of the iterator ``tensors``."""
    if isinstance(x, torch.Tensor):
        return next(tensors)
    if type(x) is dict:
        return {k: _rebuild(v, tensors) for k, v in x.items()}
    if type(x) in (list, tuple):
        return type(x)(_rebuild(v, tensors) for v in x)
    return x


def _capture(graph, stream, pool, fn):
    """``fn()`` captured into ``graph`` on ``stream`` (in ``pool``, when given); the stream is restored whatever
    happens, and a failed capture raises."""
    with torch.cuda.stream(stream):
        graph.capture_begin(*(() if pool is None else (pool,)), capture_error_mode="thread_local")
        try:
            return fn()
        finally:
            graph.capture_end()


class _Held:
    """One signature's captured step."""

    __slots__ = ("dense", "sparse", "inputs", "loss", "grads", "launches")

    def __init__(self, dense, sparse, inputs, loss, grads, launches):
        self.dense, self.sparse, self.inputs, self.loss, self.grads, self.launches = dense, sparse, inputs, loss, grads, launches


class StepGraphs:
    """The graphs of a trainer's step, by signature (module docstring)."""

    def __init__(self, trainer):
        self.trainer = trainer
        index = trainer.device.index
        self.device = torch.device("cuda", torch.cuda.current_device() if index is None else index)
        self.stream = torch.cuda.Stream(self.device)
        self.held: "collections.OrderedDict[tuple, _Held]" = collections.OrderedDict()
        self.refused: "collections.OrderedDict[tuple, None]" = collections.OrderedDict()
        self.last: Optional[tuple] = None  # the signature of the step before
        self.safe = all(getattr(m, "graph_safe", True) for m in trainer.model.modules())  # a module may opt out

    def drop(self) -> None:
        """Drop every held graph: they hold the addresses of the state a load replaces."""
        self.held.clear()
        self.last = None

    def step(self, batch) -> torch.Tensor:
        """One training step (``TorchTrainer.train_step``'s body after ``model.train()``); returns its loss."""
        t = self.trainer
        if not self.safe:
            count("rechub.train.graph.eager")
            return t._eager_step(batch)
        try:
            key, tensors = signature(batch, t)
        except TypeError:
            key, tensors = None, []
        previous, self.last = self.last, key
        if key is None or key in self.refused or any(x.device != self.device or x.requires_grad for x in tensors):
            count("rechub.train.graph.eager")
            return t._eager_step(batch)
        held = self.held.get(key)
        if held is None and key == previous:
            held = self._capture(key, batch, tensors)
            if held is None:
                count("rechub.train.graph.eager")
                return t._eager_step(batch)
            count("rechub.train.graph.capture")
        if held is None:
            count("rechub.train.graph.eager")
            return self._warm_up(batch)
        self.held.move_to_end(key)
        return self._replay(held, tensors)

    def _warm_up(self, batch) -> torch.Tensor:
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            loss = self.trainer._eager_step(batch)
        main.wait_stream(self.stream)
        return loss

    def _generators(self) -> List[torch.Generator]:
        """The trainer's generators on its device (dropout, sampled negatives): registered with a capture."""
        return [g for g in vars(self.trainer).values() if isinstance(g, torch.Generator) and g.device.type == "cuda"]

    def _optimizer_states(self) -> tuple:
        return tuple(len(opt.state) for opt in getattr(self.trainer.optimizer, "optimizers", [self.trainer.optimizer]))

    def _capture(self, key, batch, tensors) -> Optional[_Held]:
        """Capture the step at ``batch``'s signature, or refuse the signature (None) where it cannot be captured."""
        t = self.trainer
        main = torch.cuda.current_stream(self.device)
        inputs = [x.clone() for x in tensors]
        static = _rebuild(batch, iter(inputs))
        generators = self._generators()
        dense, sparse = torch.cuda.CUDAGraph(), None
        for g in generators:
            dense.register_generator_state(g)
        before, states = launch_counts(), self._optimizer_states()
        t.optimizer.zero_grad(set_to_none=True)  # the gradients the capture makes live in its pool
        self.stream.wait_stream(main)
        try:
            loss, records = _capture(dense, self.stream, None, lambda: t._dense_step(static))
            if records:
                sparse = torch.cuda.CUDAGraph()
                _capture(sparse, self.stream, dense.pool(), lambda: t._sparse_step(records))
            if self._optimizer_states() != states:
                raise RuntimeError("the optimizer made state inside the capture: each replay would make it anew")
            failed = False
        except Exception:
            failed = True
        main.wait_stream(self.stream)
        captured = _difference(launch_counts(), before)
        add_launch_counts({k: -n for k, n in captured.items()})  # a capture runs nothing: each replay counts them
        if failed:
            self._end_failed_capture(generators)
            t.optimizer.zero_grad(set_to_none=True)
            self.refused[key] = None
            while len(self.refused) > MAX_REFUSED:
                self.refused.popitem(last=False)
            count("rechub.train.graph.refused")
            return None
        params = [p for group in t.optimizer.param_groups for p in group["params"]]
        held = _Held(dense, sparse, inputs, loss, [(p, p.grad) for p in params if p.grad is not None], captured)
        self.held[key] = held
        while len(self.held) > MAX_GRAPHS:
            self.held.popitem(last=False)
        return held

    def _end_failed_capture(self, generators) -> None:
        """Return the generators to eager draws after a failed capture, by a capture of nothing that registers
        them: a capture that fails before its end leaves them (and the default generator) in capture mode."""
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the empty graph's warning
            _capture(graph, self.stream, None, lambda: None)

    @staticmethod
    def _replay(held: _Held, tensors) -> torch.Tensor:
        with annotate("rechub.train.graph"):
            for dst, src in zip(held.inputs, tensors):
                dst.copy_(src)
            held.dense.replay()
        if held.sparse is not None:
            with annotate("rechub.train.sparse_update"):
                held.sparse.replay()
        for p, g in held.grads:
            if p.grad is not g:  # an eager step in between set it to its own
                p.grad = g
        add_launch_counts(held.launches)
        count("rechub.train.graph.replay")
        return held.loss.clone()


def _difference(after: dict, before: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
