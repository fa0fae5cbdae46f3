"""Tracing / profiling hooks: the program's spans, a capture of them, and the card's memory.

Counterpart of ``torch_rechub_tpu/utils/profiling.py``:

- ``trace(log_dir)``: a ``torch.profiler`` capture of everything inside
  (host operations and, with a card, its kernels and copies), written as a
  Chrome trace to ``<log_dir>/trace.json`` (open it in Perfetto or
  ``chrome://tracing``).
- ``annotate(name)``: a named span.  With no profiler running it is one
  shared no-op context: a call and a bool, no ``record_function``, no clock
  read.  Under a profiler it opens ``torch.profiler.record_function(name)``,
  so the span lands in the trace on the kernels' clock (and on the card as
  a user annotation over the kernels launched inside it), and it records
  ``(name, parent, start_ns, end_ns)`` in memory (``spans()``).
- ``spans()`` / ``clear_spans()`` / ``dropped_spans()``: that record.
- ``count(name)`` / ``counters()``: counters of the program's events,
  kept with or without a profiler (a dict update under a lock, no clock
  read); ``clear_spans()`` resets them too.
- ``device_memory_stats()``: ``torch.cuda.memory_stats`` of every visible card.

The program's spans, every one named ``rechub.*``, and where each opens:

- ``rechub.train_step``: ``trainers/base.py`` ``TorchTrainer.train_step``
  (the CTR, Seq, Match and RQ-VAE trainers), the whole step; inside it, in
  order, ``rechub.train.forward`` (``loss_fn`` under the row recorder),
  ``rechub.train.backward`` (``loss.backward()``, and the gradients'
  all-reduce under a mesh), ``rechub.train.optimizer``
  (``optimizer.step()``) and ``rechub.train.sparse_update``
  (``apply_sparse_table_updates``).  A step replayed as CUDA graphs
  (``trainers/graph_step.py``) opens instead ``rechub.train.graph`` (the
  copies of the batch into the graph's inputs and the replay of forward,
  backward and dense optimizer) and ``rechub.train.sparse_update`` (the
  replay of the sparse update's graph); a replay runs no forward,
  backward, optimizer or gather on the host, so their spans do not open.
- ``rechub.sparse.gather``: ``ops/sparse_update.py`` ``gather_rows``, a
  table's gather, the recorded leaf or the plain read.
- ``rechub.hstu.forward``: ``models/generative/hstu.py``
  ``HSTUModel.forward``, the whole forward.
- ``rechub.retrieval.topk``: ``serving/retrieval.py`` ``topk_scores``,
  ``torch.topk`` alone, after the product ``users @ items.T``.
- ``rechub.mla.attention``: ``basic/mla.py`` ``MLA.forward``, the latent
  attention with its projections; its backward opens
  ``rechub.mla.attention.bwd`` (from the output's gradient to the input's and
  the projections', on the thread that runs the backward).
- ``rechub.moe.route``, ``rechub.moe.dispatch``, ``rechub.moe.experts``:
  ``basic/moe.py`` ``MoE.forward``: the router's logits, softmax, top-k and
  balance loss; the sort of the pairs on held experts, the gather of their
  rows and the weighted scatter-add back; the held experts' products.  Their
  backward opens ``rechub.moe.experts.bwd`` and ``rechub.moe.dispatch.bwd``
  (the products' and the gather's and scatter-add's backward, inside their
  autograd functions, on the thread that runs the backward).
- ``rechub.dist.all_reduce``: ``parallel/distributed.py``
  ``all_reduce_gradients``, the gradients' sum over the data group;
  ``rechub.dist.all_gather``: its ``all_gather`` (the sparse rows' ids and
  gradients over the data group, among others).

The trainer's graph path counts, in ``counters()``:
``rechub.train.graph.capture`` (steps that captured their signature's
graphs, then replayed them), ``rechub.train.graph.replay`` (steps that
replayed held graphs, the capturing steps too), ``rechub.train.graph.eager``
(steps on the card without a mesh that ran eagerly: a signature's first
step, and every step of one that cannot be captured) and
``rechub.train.graph.refused`` (captures that failed, whose signature then
stays eager).

Counted by amount: ``rechub.moe.routed_pairs`` (the (token, expert) pairs
that fell on a layer's held experts) and ``rechub.moe.max_expert_pairs``
(the largest held expert's pairs), each summed over the expert layers'
forwards, from the counts the dispatch reads on the host anyway;
``rechub.dist.calls`` and ``rechub.dist.bytes`` (each collective of
``parallel/distributed.py`` and the bytes of its input).

``with trace(log_dir):`` (or any ``torch.profiler.profile``) captures them.
After the capture, ``spans()`` lists the recorded spans in the order they
opened, each ``(name, parent, start_ns, end_ns)``: ``parent`` is the index
in the list of the span that enclosed it on the same thread (``None`` at the
root), the times are ``time.perf_counter_ns()`` (``end_ns`` is ``None``
while the span is open).  A step's stages are the spans whose ``parent`` is
that step's ``rechub.train_step``::

    with trace("runs/trace"):
        trainer.train_step(*batch)
    record = spans()
    step = next(i for i, s in enumerate(record) if s[0] == "rechub.train_step")
    stages = {name: (end - start) / 1e6 for name, parent, start, end in record if parent == step}  # host ms

Reading does not clear the record (several readers may read one capture);
``clear_spans()`` does, and resets the counters.  It keeps at most
``MAX_SPANS``, drops the newest beyond them and counts those in
``dropped_spans()``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

MAX_SPANS = 65536
Span = Tuple[str, Optional[int], int, Optional[int]]

_OFF = contextlib.nullcontext()
_LOCK = threading.Lock()
_RECORD: List[list] = []  # [name, parent, start_ns, end_ns], in the order the spans opened
_DROPPED = 0
_GENERATION = object()  # replaced at each clear: a span opened before it is no later span's parent
_LOCAL = threading.local()  # .open: (record index, generation) of this thread's open spans, innermost last
_COUNTS: Dict[str, int] = {}


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture the enclosed block with ``torch.profiler`` (the card's activity too, where there is one) and write
    ``<log_dir>/trace.json``; yields the profiler, whose ``key_averages()`` the caller may read."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class _Span:
    """A span under a running profiler: ``record_function`` and an entry of the in-memory record."""

    __slots__ = ("name", "function", "entry")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _DROPPED
        self.function = torch.profiler.record_function(self.name)
        self.function.__enter__()
        stack = _LOCAL.__dict__.setdefault("open", [])
        with _LOCK:
            parent = stack[-1][0] if stack and stack[-1][1] is _GENERATION else None
            if len(_RECORD) < MAX_SPANS:
                self.entry = [self.name, parent, time.perf_counter_ns(), None]
                stack.append((len(_RECORD), _GENERATION))
                _RECORD.append(self.entry)
            else:
                self.entry = None
                _DROPPED += 1
        return self

    def __exit__(self, *exc):
        if self.entry is not None:
            self.entry[3] = time.perf_counter_ns()
            _LOCAL.open.pop()
        return self.function.__exit__(*exc)


def annotate(name: str):
    """A named span: the shared no-op context with no profiler running, else ``record_function(name)`` and an
    entry of ``spans()`` (module docstring)."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name)


def spans() -> List[Span]:
    """A copy of the recorded spans, ``(name, parent, start_ns, end_ns)`` in the order they opened; does not clear."""
    with _LOCK:
        return [tuple(e) for e in _RECORD]


def clear_spans() -> None:
    """Empty the record and its count of dropped spans, and reset the counters."""
    global _DROPPED, _GENERATION
    with _LOCK:
        _RECORD.clear()
        _DROPPED = 0
        _GENERATION = object()
        _COUNTS.clear()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` (one) to the counter ``name``, with or without a profiler."""
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of the counters since the last ``clear_spans()``, ``{name: count}``; does not clear."""
    with _LOCK:
        return dict(_COUNTS)


def dropped_spans() -> int:
    """Spans left out of the record since the last ``clear_spans()``, the record being full."""
    return _DROPPED


def device_memory_stats() -> Dict[str, Dict]:
    """``torch.cuda.memory_stats`` of every visible card, keyed ``cuda:<i>``; empty without one."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}
