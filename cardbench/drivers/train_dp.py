"""Closed-loop data-parallel training: the cell's trainer on a (ranks, 1) data mesh, one card a rank.

The ranks are started through the port's ``parallel.distributed.spawn``,
rank 0 in this process (so that its set-up, window, spans and trace are the
run's own) and the others in new ones, under NCCL on the cards (gloo on the
CPU, or where the ranks share a card).  Every rank makes the same pool of global batches from the seed and
the same weights, builds the cell's trainer with ``mesh=create_mesh(ranks,
1)``, and steps through its own rows of each global batch (rank ``r`` the
``r``-th of ``ranks`` equal blocks).  Each rank runs on two CPUs of its own.

- The first steps: rank 0 reads what its state says of them as the ``train``
  driver does (each step's loss, the global batch's mean; the gradient each
  leaf's optimizer took, after the gradients' all-reduce; each leaf's
  change).  Then ``replica_gap``: the largest difference between a rank's
  parameters and rank 0's, over rank 0's largest magnitude of that leaf.
- The window: steps until rank 0's clock passes ``seconds`` (rank 0 tells
  the others before each step, over a gloo group of the host), ended by a
  synchronise; ``train_examples_per_s`` counts every rank's rows, and the
  window's model FLOPs are every rank's.  A traced run then profiles rank 0
  while the others take the same steps; its ``traced_work`` is rank 0's own
  rows of those steps, the work that rank 0's kernels in the trace did.
- Every rank reports the top-level modules it imported; a rank that
  imported JAX or the JAX package fails the run.

Once the ranks are done, the reference runs rank 0's first steps again on
the global batches, on rank 0's card, and ``judge.train_gaps`` compares.
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist

from .. import harness, judge, weights
from ..device import Phases, build_kernels, peak_bytes, release, sync
from ..generators import GENERATORS
from ..trace import capture
from .train import TRACED_STEPS, change_norms, reference_readings

SPAWN_TIMEOUT_S = 600.0


def run(c, seed: int, seconds: float, trace: bool, device, t0: float, fault=None, overrides=None) -> dict:
    from torch_rechub_tpu_torch.parallel.distributed import default_backend, spawn

    phases = Phases(t0, device)
    phases.mark("imports and the card")
    build_kernels(c.kind.KERNELS["train"], device)  # built once here; the other ranks load them
    phases.mark("kernels")
    try:  # the ranks start from every CPU, then each takes two of its own
        os.sched_setaffinity(0, range(os.cpu_count()))
    except OSError:
        pass
    backend = default_backend(c.traffic["ranks"]) if device.type == "cuda" else "gloo"  # gloo where ranks share a card
    out = spawn(rank_main, c.traffic["ranks"], args=(c.workload["name"], overrides, seed, seconds, trace, device.type, fault, t0), backend=backend, timeout_s=SPAWN_TIMEOUT_S, here=0)
    phases.marks += out.pop("marks")
    release(device)
    reference = reference_readings(c.kind, c.cfg, c.kind.specs(c.cfg), out["checked"], seed, device)
    checks = {**judge.train_gaps(out["program"], reference), "replica_gap": out.pop("replica_gap")}
    phases.write()
    return {**out, "correct": judge.verdict(checks, c.limits), "checks": checks, "reference": reference}


def _pin(rank: int, ranks: int) -> None:
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) >= 2 * ranks + 2:
        os.sched_setaffinity(0, cpus[2 + 2 * rank: 4 + 2 * rank])


def _replica_gap(model) -> float:
    """The largest ``max |p - p_0| / max |p_0|`` over the leaves, ``p_0`` being rank 0's: 0 where the replicas agree."""
    from torch_rechub_tpu_torch.parallel.distributed import all_reduce, broadcast_

    worst = None
    for _, p in sorted(model.named_parameters()):
        first = broadcast_(p.detach().clone(), src=0)
        gap = (p.detach() - first).abs().max() / first.abs().max().clamp_min(1e-30)
        worst = gap if worst is None else torch.maximum(worst, gap)
    return float(all_reduce(worst.reshape(1), dist.group.WORLD, dist.ReduceOp.MAX))


def rank_main(rank: int, workload: str, overrides, seed: int, seconds: float, trace: bool, device_type: str, fault, t0: float):
    """One rank's set-up, first steps, window and traced steps; on rank 0 their readings, elsewhere None."""
    from torch_rechub_tpu_torch.parallel.mesh import create_mesh

    _pin(rank, dist.get_world_size())
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False  # the configurations state float32
    harness.set_cache_dirs()
    c = harness.resolve(workload, overrides)
    kind, cfg, traffic, ranks = c.kind, c.cfg, c.traffic, dist.get_world_size()
    device = torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda" else torch.device("cpu")
    control = dist.new_group(backend="gloo")  # rank 0's clock, told to the others on the host
    marks = []  # rank 0's stages, in seconds since the run started (t0)

    def mark(name):
        sync(device)
        marks.append((f"rank 0 {name}", time.perf_counter() - t0))

    specs = kind.specs(cfg)
    pool = GENERATORS[traffic["generator"]](traffic, cfg, seed, device)
    work = kind.work(pool)
    share = traffic["batch"] // ranks
    own = kind.work({k: t[:, rank * share:(rank + 1) * share] for k, t in pool.items()})  # this rank's rows of each batch
    mark("inputs")
    trainer = kind.build_trainer(cfg, weights.make(specs, seed, device), seed, device, mesh=create_mesh(ranks, 1))
    mark("weights and trainer")
    if fault is not None:
        fault(trainer)

    def local(i):
        return {k: t[rank * share:(rank + 1) * share] for k, t in kind.batch(pool, i).items()}

    first = traffic["first_steps"]
    losses, grads = [], None
    for i in range(first):
        losses.append(kind.train_step(trainer, local(i)))
        if i == 0 and rank == 0:
            grads = kind.first_grad_norms(cfg, trainer)
    program = None
    if rank == 0:
        program = {"losses": [float(x) for x in losses], "first_grad_norms": grads, "change_norms": change_norms(kind.values(cfg, trainer), weights.make(specs, seed, device))}
    gap = _replica_gap(trainer.model)
    checked = [{k: t.clone() for k, t in kind.batch(pool, i).items()} for i in range(first)] if rank == 0 else None
    release(device)
    mark("first steps")
    setup_s = time.perf_counter() - t0

    steps, start = 0, time.perf_counter()
    while True:
        go = torch.tensor([int(time.perf_counter() - start < seconds)])
        dist.broadcast(go, src=0, group=control)
        if not go.item():
            break
        kind.train_step(trainer, local(first + steps))
        steps += 1
    sync(device)
    window_s = time.perf_counter() - start
    traced = None
    if trace:
        step = lambda i: kind.train_step(trainer, local(first + steps + i))  # noqa: E731
        if rank == 0:
            traced = capture(step, TRACED_STEPS)
        else:
            for i in range(2 * TRACED_STEPS):
                step(i)
            sync(device)
    memory = peak_bytes(device)
    del trainer, losses
    release(device)
    found = [None] * ranks
    dist.all_gather_object(found, harness.forbidden_modules(), group=control)
    bad = {r: f for r, f in enumerate(found) if f}
    if bad:
        raise harness.Refused(f"ranks imported {bad}; the benchmark runs the port only")
    if rank != 0:
        return None
    done = [work[(first + i) % len(work)] for i in range(steps)]
    return {
        "attempted": steps,
        "failed": 0,
        "end_to_end": {"train_examples_per_s": sum(w["rows"] for w in done) / window_s, "setup_s": setup_s},
        "window": {"n": steps, "seconds": window_s, "flops": sum(kind.train_flops(cfg, w) for w in done)},
        "traced_work": [own[(first + steps + i) % len(own)] for i in range(TRACED_STEPS)] if trace else [],
        "memory_peak_bytes": memory,
        "trace": traced,
        "program": program,
        "replica_gap": gap,
        "checked": checked,
        "marks": marks,
    }

