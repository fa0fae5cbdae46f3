"""Multi-task learning helpers: the shared / task parameter split, MetaBalance, GradNorm.

Counterpart of ``torch_rechub_tpu/utils/mtl.py``.  Parameters are sorted
by their path as the JAX package writes it, flax's ``keystr``
(``"['experts_3']['Dense_0']['kernel']"``): :func:`flax_keystr` builds that
string from a port parameter's name, so the split and GradNorm's choice of
leaf (the last shared 2-D leaf in the *sorted* ``keystr`` order; ``'`` and
``]`` do not sort as ``.`` does) are the JAX package's.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import torch

_TASK_MARKERS = ("tower", "gate", "ait", "predict", "info")


def is_shared_path(path_str: str) -> bool:
    """Task-specific when the path names a tower, gate, AITM block, prediction or info layer; else shared
    (embeddings, bottoms, experts, CGC layers and anything unmatched)."""
    p = path_str.lower()
    return not any(m in p for m in _TASK_MARKERS)


def flax_keystr(name: str, ndim: int) -> str:
    """The flax ``keystr`` of the port parameter ``name`` with ``ndim`` dimensions.

    A ``Linear``'s 2-D ``weight`` is flax's ``kernel``, a 1-D ``weight``
    (``BatchNorm``) its ``scale``; every other name is flax's already.
    """
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel" if ndim >= 2 else "scale"
    return "".join(f"['{p}']" for p in parts)


def shared_task_mask(named_parameters) -> Dict[str, bool]:
    """``{name: True}`` for a shared parameter, ``False`` for a task-specific one."""
    return {name: is_shared_path(flax_keystr(name, p.ndim)) for name, p in named_parameters}


def gradnorm_leaf(named_parameters) -> str:
    """GradNorm's leaf: the last shared 2-D parameter by sorted flax ``keystr``.  Raises if there is none."""
    candidates = {flax_keystr(name, p.ndim): name for name, p in named_parameters if p.ndim == 2 and is_shared_path(flax_keystr(name, p.ndim))}
    if not candidates:
        raise ValueError("gradnorm requires a 2-D shared parameter")
    return candidates[sorted(candidates)[-1]]


def metabalance_scale(grads_list: List[Mapping[str, torch.Tensor]], norms_state: Mapping[str, torch.Tensor], relax_factor: float = 0.7, beta: float = 0.9, task_norms: Optional[Mapping[str, torch.Tensor]] = None) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Scale each task's gradient toward task 0's norm; return ``(summed, new_norms)``.

    For every parameter: ``norms[t] = beta·norms[t] + (1 − beta)·‖g_t‖``;
    ``g_t ← g_t·(norms[0] / (norms[t] + 1e-5))·relax + g_t·(1 − relax)``;
    the output gradient is the sum over tasks.  ``grads_list`` holds one
    ``{name: gradient}`` per task, ``norms_state`` one ``(n_task,)`` tensor
    per name.  ``task_norms`` gives the ``(n_task,)`` ``‖g_t‖`` per name where
    a gradient is a part of its parameter's (a row shard's rows: the trainer
    sums the squares over the shard's group); by default they are the
    gradients' own norms.
    """
    summed, new_norms = {}, {}
    for name in grads_list[0]:
        g_ts = [g[name] for g in grads_list]
        cur = task_norms[name] if task_norms is not None else torch.stack([torch.linalg.vector_norm(g.reshape(-1)) for g in g_ts])
        upd = norms_state[name] * beta + (1 - beta) * cur
        scale = upd[0] / (upd + 1e-5) * relax_factor + (1.0 - relax_factor)
        total = g_ts[0] * scale[0]
        for t in range(1, len(g_ts)):
            total = total + g_ts[t] * scale[t]
        summed[name], new_norms[name] = total, upd
    return summed, new_norms


def gradnorm_weight_grads(shared_grad_norms: torch.Tensor, loss_weight: torch.Tensor, loss_vals: torch.Tensor, initial_task_loss: torch.Tensor, alpha: float) -> torch.Tensor:
    """d(GradNorm loss)/d(w) in closed form, where ``norms_i = w_i·‖g_i‖`` and the loss is
    ``Σ |norms_i − mean(norms)·mean(r)^alpha|``, ``r = L / max(L_0, 1e-12)``, the target held constant.

    ``|x|``'s derivative is taken as ``jnp.abs``'s: 1 for ``x >= 0`` (at 0 too, where ``torch.sign`` would
    give 0), else −1.
    """
    norms = loss_weight * shared_grad_norms
    loss_ratio = loss_vals / torch.clamp_min(initial_task_loss, 1e-12)
    constant = norms.mean() * loss_ratio.mean() ** alpha
    return torch.where(norms - constant >= 0, 1.0, -1.0) * shared_grad_norms
