"""Preemption-safe training checkpoints: the full train state and its step.

Counterpart of ``torch_rechub_tpu/utils/checkpoint.py`` on its msgpack path
(there is no orbax here): each checkpoint is one ``torch.save`` of the state
to ``ckpt_{step}.pt``, written to a temporary file and moved into place with
``os.replace``, so a reader sees a whole file or none, and only the newest
``max_to_keep`` stay.  A trainer's state is a nested dict of tensors
(``TorchTrainer.train_state``): the model's ``state_dict``, the
optimizer's, the sparse tables' accumulators and the step.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterator, Optional, Tuple

import torch


def flat_tensors(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` of every leaf of a tree of dicts, lists and tuples, paths joined by ``/``."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from flat_tensors(value, f"{prefix}/{key}")
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from flat_tensors(value, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _map_tensors(fn, tree: Any, prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {key: _map_tensors(fn, value, f"{prefix}/{key}") for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, value, f"{prefix}/{i}") for i, value in enumerate(tree))
    return fn(prefix, tree) if isinstance(tree, torch.Tensor) else tree


def _empty_containers(tree: Any, prefix: str = "") -> Iterator[str]:
    if isinstance(tree, (dict, list, tuple)):
        if not tree:
            yield prefix
        for key, value in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
            yield from _empty_containers(value, f"{prefix}/{key}")


def check_state_shapes(restored: Any, template: Any, target: str) -> None:
    """Raise a ``ValueError`` naming every tensor of ``template`` that ``restored`` lacks, holds at another shape,
    or holds besides (outside a container that is empty in ``template``: the state an optimizer makes at its
    first step); embedding tables whose ROW counts alone differ get ``check_table_rows``' targeted message."""
    from ..trainers.base import check_table_rows  # the trainers import this module

    got = {k: v for k, v in flat_tensors(restored) if isinstance(v, torch.Tensor)}
    want = {k: v for k, v in flat_tensors(template) if isinstance(v, torch.Tensor)}
    check_table_rows(got, want, target)
    empty = tuple(p + "/" for p in _empty_containers(template))
    problems = [f"{k}: missing from the checkpoint" for k in sorted(want.keys() - got.keys())]
    problems += [f"{k}: not in the model's state" for k in sorted(got.keys() - want.keys()) if not k.startswith(empty)]
    problems += [f"{k}: checkpoint {tuple(got[k].shape)} vs model {tuple(want[k].shape)}" for k in sorted(got.keys() & want.keys()) if got[k].shape != want[k].shape]
    if problems:
        raise ValueError(f"checkpoint {target!r} does not fit the model's train state: " + "; ".join(problems))


class TrainCheckpointer:
    """Versioned train-state checkpoints: ``save(step, state)`` / ``restore(template)``.

    ``use_orbax`` is the JAX package's switch between an Orbax manager and
    flax msgpack files.  The port has one format, ``ckpt_<step>.pt`` written
    by ``torch.save``, which either value selects: it is taken so that a JAX
    caller's ``TrainCheckpointer(directory, 3, False)`` runs unchanged.
    """

    def __init__(self, directory: str, max_to_keep: int = 3, use_orbax: bool = True):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def save(self, step: int, state: Dict) -> str:
        """Write ``state`` as checkpoint ``step`` (atomically), then drop all but the newest ``max_to_keep``."""
        path = self.path(step)
        tmp = path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        self._gc()
        return path

    def steps(self):
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"ckpt_(\d+)\.pt", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return max(steps) if steps else None

    def restore(self, template: Any, step: Optional[int] = None) -> Tuple[Any, Optional[int]]:
        """``(state, step)`` of checkpoint ``step`` (the latest when None), each tensor on the device of the
        template's tensor at its path; ``(template, None)`` when there is none.  Loads with ``weights_only=True``
        and raises a ``ValueError`` naming every tensor whose shape (or presence) differs from the template's."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return template, None
        path = self.path(step)
        restored = torch.load(path, map_location="cpu", weights_only=True)
        check_state_shapes(restored, template, path)
        devices = {k: v.device for k, v in flat_tensors(template) if isinstance(v, torch.Tensor)}
        # a tensor the template lacks (an optimizer's first-step state) stays on the CPU: load_state_dict places it
        return _map_tensors(lambda k, t: t.to(devices[k]) if k in devices else t, restored), step

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.max_to_keep]:
            os.remove(self.path(s))
