"""Carry weights of the JAX package's flax models into the port's modules.

Takes a flax ``params`` tree as nested dicts of numpy arrays (no JAX needed:
``jax.device_get`` of the tree, or arrays from a checkpoint) and loads it
into the port's counterpart module.  The mapping:

- ``Dense.kernel (in, out)`` -> ``Linear.weight (out, in)``; ``Dense.bias`` as is
- ``LayerNorm.scale`` / ``bias`` -> ``LayerNorm.weight`` / ``bias``
- ``layer_{i}`` -> ``layers.{i}`` (``HSTUBlock``'s ``nn.ModuleList``)
- every other leaf (``rab/pos_w``, ``rab/ts_w``, ``token_embedding``,
  ``position_embedding``, ``time_embedding``, ``output_bias``,
  ``output_projection``, ``output_projection_bias``) is copied as is.

``proj1``'s output columns keep the reference's q | k | u | v order, which
``HSTULayer`` splits the same way.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_LAYER = re.compile(r"^layer_(\d+)$")


def flax_to_state_dict(params: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flatten a flax params tree into the port's ``state_dict`` names."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in params.items():
        m = _LAYER.match(key)
        name = f"layers.{m.group(1)}" if m else key
        if isinstance(value, Mapping):
            out.update(flax_to_state_dict(value, f"{prefix}{name}."))
            continue
        array = np.asarray(value)
        if key == "kernel":
            name, array = "weight", array.T
        elif key == "scale":
            name = "weight"
        out[f"{prefix}{name}"] = torch.tensor(array)
    return out


def load_flax_params(module: torch.nn.Module, params: Mapping[str, Any]) -> torch.nn.Module:
    """Copy a flax ``params`` tree into ``module`` (every parameter, strictly)."""
    module.load_state_dict(flax_to_state_dict(params), strict=True)
    return module
