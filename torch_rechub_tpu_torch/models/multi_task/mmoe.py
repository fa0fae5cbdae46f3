"""MMOE (KDD'2018), multi-gate mixture of experts.

Counterpart of ``torch_rechub_tpu/models/multi_task/mmoe.py``: ``n_expert``
shared expert MLPs, a softmax gate per task (``MLP(dims=(n_expert,),
activation="softmax", output_layer=False)``, so a BatchNorm stands before
the softmax), a tower per task.  The experts' outputs stack to
``(B, E, D)`` and each gate pools them by one einsum.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from ...basic.layers import MLP, prediction
from ...ops.embedding import EmbeddingCollection, squeeze_width


class MMOE(nn.Module):
    def __init__(self, features: Sequence, task_types: Sequence[str], n_expert: int, expert_params: Dict[str, Any], tower_params_list: Sequence[Dict[str, Any]], generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.features, self.task_types, self.n_expert = tuple(features), tuple(task_types), n_expert
        self.embedding = EmbeddingCollection(self.features, generator=generator, device=device)
        width, d = squeeze_width(self.features), expert_params["dims"][-1]
        for i in range(n_expert):
            self.add_module(f"experts_{i}", MLP(width, output_layer=False, **expert_params, generator=generator, device=device))
        for i in range(len(self.task_types)):
            self.add_module(f"gates_{i}", MLP(width, output_layer=False, dims=(n_expert,), activation="softmax", generator=generator, device=device))
        for i in range(len(self.task_types)):
            self.add_module(f"towers_{i}", MLP(d, **tower_params_list[i], generator=generator, device=device))

    def forward(self, x: Mapping[str, torch.Tensor], generator: Optional[torch.Generator] = None) -> torch.Tensor:
        embed_x = self.embedding(x, self.features, squeeze_dim=True)
        expert_outs = torch.stack([getattr(self, f"experts_{i}")(embed_x, generator=generator) for i in range(self.n_expert)], dim=1)  # (B, E, D)
        ys = []
        for i, task_type in enumerate(self.task_types):
            g = getattr(self, f"gates_{i}")(embed_x, generator=generator)  # (B, E) softmax
            pooled = torch.einsum("be,bed->bd", g, expert_outs)
            ys.append(prediction(getattr(self, f"towers_{i}")(pooled, generator=generator), task_type))
        return torch.cat(ys, dim=1)
