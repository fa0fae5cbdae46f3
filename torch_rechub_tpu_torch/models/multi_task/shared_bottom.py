"""SharedBottom (Caruana 1997) multi-task model.

Counterpart of ``torch_rechub_tpu/models/multi_task/shared_bottom.py``: one
shared bottom MLP, a tower MLP per task, a prediction head per task type.
``forward`` returns ``(B, n_task)`` probabilities (regression tasks pass
through).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from ...basic.layers import MLP, prediction
from ...ops.embedding import EmbeddingCollection, squeeze_width


class SharedBottom(nn.Module):
    def __init__(self, features: Sequence, task_types: Sequence[str], bottom_params: Dict[str, Any], tower_params_list: Sequence[Dict[str, Any]], generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.features, self.task_types = tuple(features), tuple(task_types)
        self.embedding = EmbeddingCollection(self.features, generator=generator, device=device)
        self.bottom_mlp = MLP(squeeze_width(self.features), **{**bottom_params, "output_layer": False}, generator=generator, device=device)
        for i in range(len(self.task_types)):  # flax names a list of submodules towers_{i}
            self.add_module(f"towers_{i}", MLP(bottom_params["dims"][-1], **tower_params_list[i], generator=generator, device=device))

    def forward(self, x: Mapping[str, torch.Tensor], generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.bottom_mlp(self.embedding(x, self.features, squeeze_dim=True), generator=generator)
        ys = [prediction(getattr(self, f"towers_{i}")(h, generator=generator), t) for i, t in enumerate(self.task_types)]
        return torch.cat(ys, dim=1)
