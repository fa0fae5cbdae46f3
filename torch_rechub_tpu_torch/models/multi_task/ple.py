"""PLE (RecSys'2020), progressive layered extraction.

Counterpart of ``torch_rechub_tpu/models/multi_task/ple.py``: ``n_level``
stacked CGC layers of task-specific and shared experts; a softmax gate per
task over its own and the shared experts, and on every level but the last
a shared gate over all of them.  flax's names: ``cgc_layers_{i}``, and in a
CGC ``experts_specific_{i}``, ``experts_shared_{i}``, ``gates_specific_{i}``,
``gate_shared``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence

import torch
from torch import nn

from ...basic.layers import MLP, prediction
from ...ops.embedding import EmbeddingCollection, squeeze_width


class CGC(nn.Module):
    """One level: ``forward(x_list)`` takes ``n_task + 1`` inputs (each task's, then the shared one) and returns
    ``n_task`` outputs, plus the shared one below the last level."""

    def __init__(self, in_features: int, cur_level: int, n_level: int, n_task: int, n_expert_specific: int, n_expert_shared: int, expert_params: Dict[str, Any], generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cur_level, self.n_level, self.n_task = cur_level, n_level, n_task
        self.n_expert_specific, self.n_expert_shared = n_expert_specific, n_expert_shared
        n_all = n_expert_specific * n_task + n_expert_shared

        def expert():
            return MLP(in_features, output_layer=False, **expert_params, generator=generator, device=device)

        def gate(n):
            return MLP(in_features, output_layer=False, dims=(n,), activation="softmax", generator=generator, device=device)

        for i in range(n_task * n_expert_specific):
            self.add_module(f"experts_specific_{i}", expert())
        for i in range(n_expert_shared):
            self.add_module(f"experts_shared_{i}", expert())
        for i in range(n_task):
            self.add_module(f"gates_specific_{i}", gate(n_expert_specific + n_expert_shared))
        if cur_level < n_level:
            self.gate_shared = gate(n_all)

    def forward(self, x_list: Sequence[torch.Tensor], generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        ns = self.n_expert_specific
        specific_outs = [getattr(self, f"experts_specific_{j}")(x_list[j // ns], generator=generator)[:, None, :] for j in range(self.n_task * ns)]
        shared_outs = [getattr(self, f"experts_shared_{j}")(x_list[-1], generator=generator)[:, None, :] for j in range(self.n_expert_shared)]
        outs = []
        for i in range(self.n_task):
            g = getattr(self, f"gates_specific_{i}")(x_list[i], generator=generator)[..., None]  # (B, ns + nsh, 1)
            experts = torch.cat(specific_outs[i * ns:(i + 1) * ns] + shared_outs, dim=1)
            outs.append((g * experts).sum(1))
        if self.cur_level < self.n_level:
            g = self.gate_shared(x_list[-1], generator=generator)[..., None]
            outs.append((g * torch.cat(specific_outs + shared_outs, dim=1)).sum(1))
        return outs


class PLE(nn.Module):
    def __init__(self, features: Sequence, task_types: Sequence[str], n_level: int, n_expert_specific: int, n_expert_shared: int, expert_params: Dict[str, Any], tower_params_list: Sequence[Dict[str, Any]], generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.features, self.task_types, self.n_level = tuple(features), tuple(task_types), n_level
        n_task = len(self.task_types)
        self.embedding = EmbeddingCollection(self.features, generator=generator, device=device)
        width, d = squeeze_width(self.features), expert_params["dims"][-1]
        for i in range(n_level):
            self.add_module(f"cgc_layers_{i}", CGC(width if i == 0 else d, i + 1, n_level, n_task, n_expert_specific, n_expert_shared, expert_params, generator, device))
        for i in range(n_task):
            self.add_module(f"towers_{i}", MLP(d, **tower_params_list[i], generator=generator, device=device))

    def forward(self, x: Mapping[str, torch.Tensor], generator: Optional[torch.Generator] = None) -> torch.Tensor:
        embed_x = self.embedding(x, self.features, squeeze_dim=True)
        ple_outs = [embed_x] * (len(self.task_types) + 1)
        for i in range(self.n_level):
            ple_outs = getattr(self, f"cgc_layers_{i}")(ple_outs, generator=generator)
        ys = [prediction(getattr(self, f"towers_{i}")(out, generator=generator), t) for i, (out, t) in enumerate(zip(ple_outs, self.task_types))]
        return torch.cat(ys, dim=1)
