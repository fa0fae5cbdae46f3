"""Model reflection: feature-schema recovery, dummy inputs, parameter and FLOP summary.

Counterpart of ``torch_rechub_tpu/utils/model_utils.py``: ``extract_feature_info``
scans the same attribute names, ``generate_dummy_input`` draws the same numpy
arrays for a seed, ``count_parameters`` counts the same parameters (a tied
table once), and ``model_summary`` is the textual summary, its FLOP line from
``torch.utils.flop_counter.FlopCounterMode``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..basic.features import DenseFeature, SequenceFeature, SparseFeature

_FEATURE_ATTRS = (
    "features",
    "deep_features",
    "fm_features",
    "wide_features",
    "linear_features",
    "cross_features",
    "sparse_features",
    "dense_features",
    "user_features",
    "item_features",
    "history_features",
    "neg_history_features",
    "target_features",
    "neg_item_feature",
    "neg_item_features",
    "pos_item_features",
    "sample_weight_feature",
    "item_history_feature",
    "item_feature",
)


def extract_feature_info(model) -> Dict[str, List]:
    """The input feature schema of a model built from the feature dataclasses: ``{attribute: [features]}``, each
    feature once, in the order of the attributes scanned."""
    info: Dict[str, List] = {}
    seen = set()
    for attr in _FEATURE_ATTRS:
        feats = getattr(model, attr, None)
        if feats is None:
            continue
        if not isinstance(feats, (list, tuple)):
            feats = (feats,)
        kept = []
        for f in feats:
            if isinstance(f, (SparseFeature, DenseFeature, SequenceFeature)) and id(f) not in seen:
                seen.add(id(f))
                kept.append(f)
        if kept:
            info[attr] = list(kept)
    return info


def generate_dummy_input(model=None, features=None, batch_size: int = 2, seq_length: int = 10, seed: int = 0) -> Dict[str, np.ndarray]:
    """Random dict input matching a model's (or an explicit) feature schema: numpy arrays, the JAX package's for a seed."""
    rng = np.random.default_rng(seed)
    if features is None:
        if model is None:
            raise ValueError("provide model or features")
        features = [f for group in extract_feature_info(model).values() for f in group]
    x: Dict[str, np.ndarray] = {}
    for f in features:
        if f.name in x:
            continue
        if isinstance(f, SequenceFeature):
            x[f.name] = rng.integers(1, f.vocab_size, (batch_size, seq_length)).astype(np.int32)
        elif isinstance(f, SparseFeature):
            x[f.name] = rng.integers(0, f.vocab_size, batch_size).astype(np.int32)
        elif f.embed_dim > 1:
            x[f.name] = rng.normal(size=(batch_size, f.embed_dim)).astype(np.float32)
        else:
            x[f.name] = rng.normal(size=batch_size).astype(np.float32)
    return x


def count_parameters(model_or_params) -> int:
    """Parameters of a module (each shared tensor once), or elements of a ``{name: tensor}`` dict."""
    if isinstance(model_or_params, torch.nn.Module):
        return int(sum(p.numel() for p in model_or_params.parameters()))
    return int(sum(np.prod(tuple(t.shape)) for t in model_or_params.values()))


def _to_tensors(x, device):
    if isinstance(x, dict):
        return {k: _to_tensors(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_tensors(v, device) for v in x)
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x, device=device)


def forward_flops(model: torch.nn.Module, x) -> int:
    """FLOPs of one eval forward on ``x`` as ``FlopCounterMode`` counts them (a tuple ``x`` is the positional
    arguments).  It counts matrix products and convolutions, and the registered HSTU attention op (K1) by
    its formula; XLA's ``cost_analysis``, which the JAX package prints, counts other operations too, so the
    two numbers are not comparable."""
    from torch.utils.flop_counter import FlopCounterMode

    device = next(iter(model.parameters())).device
    args = _to_tensors(x, device)
    args = tuple(args) if isinstance(x, (list, tuple)) else (args,)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            model(*args)
    finally:
        model.train(was_training)
    return int(counter.get_total_flops())


def model_summary(model: torch.nn.Module, x=None, max_rows: int = 200) -> str:
    """Text summary: a row per parameter (name, shape, size), the total, and the forward's FLOPs on ``x``
    (``generate_dummy_input(model)`` when None; see :func:`forward_flops` for what is counted)."""
    if x is None:
        x = generate_dummy_input(model)
    lines = [f"{type(model).__name__} summary", "=" * 60]
    total = 0
    for rows, (name, p) in enumerate(model.named_parameters()):
        total += p.numel()
        if rows < max_rows:
            lines.append(f"{name:<58} {str(tuple(p.shape)):<18} {p.numel():>12,}")
    lines.append("=" * 60)
    lines.append(f"total parameters: {total:,}")
    lines.append(f"forward FLOPs/batch (torch.utils.flop_counter): {forward_flops(model, x):,}")
    return "\n".join(lines)
