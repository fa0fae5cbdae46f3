"""Model export with ``torch.export``, and weight-only quantization.

Counterpart of ``torch_rechub_tpu/utils/export.py``:

- ``TorchExporter`` (the JAX package's ``StableHLOExporter``) traces the
  model's eval forward, the full model or one tower (``mode="user"`` /
  ``"item"``), with ``torch.export.export`` at the example's static shapes,
  and saves the program and its weights to ``<path>.pt2``; ``load_exported``
  loads it back.  The weights are buffers of the program (``name.`` becomes
  ``name__``), read by ``torch.func.functional_call``, so the trace holds
  the model's operations and nothing else.  HSTU's attention is the
  registered op ``torch.ops.rechub.hstu_rab_fwd``: the program holds that
  call and launches K1 wherever it runs on the card (``ops/cuda/hstu_rab_attention.py``).
- ``quantize_params`` / ``dequantize_params`` / ``quantization_error``:
  int8 weight-only quantization with symmetric per-output-channel scales, or
  fp16, on the JAX package's layout.  A flax ``Dense`` kernel is ``(in,
  out)``; its ``nn.Linear`` weight here is ``(out, in)``, so a Linear
  weight's scale is the max over ``in`` (its axis 1) where the JAX package
  takes axis 0 of the kernel.  Every other 2-D parameter (tables, ``pos_w``,
  ``ts_w``) takes the max over axis 0, as there.  The arithmetic is the
  JAX package's numpy, so ``q`` and ``scale`` are its arrays bit for bit.
  Parameters named ``BatchNorm`` stay float32; a tied table is one parameter
  and is quantized once.  The JAX package's 3-D ``DenseGeneral`` kernels
  (BST's and SASRec's attention) are 2-D Linear weights here and are
  quantized, where the JAX package keeps them float32.
  ``export_quantized`` stores int8 weights with f32 scales (or fp16 weights)
  as the program's buffers and dequantizes them inside the program, so the
  file really shrinks.
"""

from __future__ import annotations

import os
from typing import Any, Collection, Dict, Mapping, Optional

import numpy as np
import torch

from .model_utils import _to_tensors


def linear_weight_names(model: torch.nn.Module) -> set:
    """The names of the ``nn.Linear`` weights of ``model``: ``(out, in)``, the transpose of a flax kernel."""
    return {f"{name}.weight" if name else "weight" for name, m in model.named_modules() if isinstance(m, torch.nn.Linear)}


def _is_quantizable(name: str, leaf: torch.Tensor) -> bool:
    return leaf.ndim == 2 and leaf.is_floating_point() and "batchnorm" not in name.lower()


def quantize_params(params: Mapping[str, torch.Tensor], mode: str = "int8", out_rows: Collection[str] = ()) -> Dict[str, Any]:
    """Quantize a ``{name: parameter}`` dict for deployment.

    ``int8``: each 2-D float parameter becomes ``{"q": int8, "scale": f32}``,
    ``scale`` shaped to broadcast against ``q``: ``(out, 1)`` for the names in
    ``out_rows`` (Linear weights, :func:`linear_weight_names`), ``(1, cols)``
    for the rest; other parameters stay as they are.  ``fp16``: every float
    parameter cast to float16.
    """
    if mode == "fp16":
        return {name: t.detach().to(torch.float16) if t.is_floating_point() else t.detach() for name, t in params.items()}
    if mode != "int8":
        raise ValueError("mode must be 'int8' or 'fp16'")
    out: Dict[str, Any] = {}
    for name, leaf in params.items():
        if not _is_quantizable(name, leaf):
            out[name] = leaf.detach()
            continue
        rows = name in out_rows
        a = leaf.detach().cpu().numpy().astype(np.float32)
        a = a.T if rows else a  # the JAX package's (in, out) layout
        scale = np.maximum(np.abs(a).max(axis=0), 1e-12) / 127.0  # per output channel
        q = np.clip(np.round(a / scale[None, :]), -127, 127).astype(np.int8)
        q, scale = (q.T, scale[:, None]) if rows else (q, scale[None, :])
        out[name] = {"q": torch.from_numpy(np.ascontiguousarray(q)).to(leaf.device), "scale": torch.from_numpy(scale.astype(np.float32)).to(leaf.device)}
    return out


def _is_q(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q", "scale"}


def dequantize(leaf):
    """One leaf of :func:`quantize_params` back to float32."""
    if _is_q(leaf):
        return leaf["q"].to(torch.float32) * leaf["scale"]
    if leaf.dtype == torch.float16:
        return leaf.to(torch.float32)
    return leaf


def dequantize_params(qparams: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`quantize_params` (int8 or fp16)."""
    return {name: dequantize(leaf) for name, leaf in qparams.items()}


def quantization_error(params: Mapping[str, torch.Tensor], mode: str = "int8", out_rows: Collection[str] = ()) -> float:
    """Max relative reconstruction error over the parameters, ``max |a − deq(q(a))| / max |a|`` (float32, as the
    JAX package computes it)."""
    deq = dequantize_params(quantize_params(params, mode, out_rows))
    errs = []
    for name, a in params.items():
        a, b = a.detach().cpu().numpy().astype(np.float32), deq[name].cpu().numpy().astype(np.float32)
        denom = np.maximum(np.abs(a).max(), 1e-12)
        errs.append(float(np.abs(a - b).max() / denom))
    return max(errs) if errs else 0.0


class _Program(torch.nn.Module):
    """The forward that is exported: the model's weights as buffers (int8 ``q`` and ``scale``, fp16 or as they
    are), dequantized and read through ``functional_call``.  The model itself is not a submodule, so none of its
    own parameters is lifted into the program."""

    def __init__(self, model: torch.nn.Module, state: Mapping[str, Any], mode: Optional[str]):
        super().__init__()
        object.__setattr__(self, "model", model)
        self.mode = mode
        self.names = list(state)
        for name, leaf in state.items():
            key = name.replace(".", "__")
            if _is_q(leaf):
                self.register_buffer(key + "__q", leaf["q"])
                self.register_buffer(key + "__scale", leaf["scale"])
            else:
                self.register_buffer(key, leaf.detach())

    def forward(self, *args):
        state = {}
        for name in self.names:
            key = name.replace(".", "__")
            leaf = {"q": getattr(self, key + "__q"), "scale": getattr(self, key + "__scale")} if hasattr(self, key + "__q") else getattr(self, key)
            state[name] = dequantize(leaf)
        kwargs = {} if self.mode is None else {"mode": self.mode}
        return torch.func.functional_call(self.model, state, args, kwargs)


class TorchExporter:
    """Export a model's eval forward with ``torch.export``; the counterpart of ``StableHLOExporter``.

    Args:
        model: a module of the port, following its call conventions (one
            input, a dict of arrays or a token tensor; or a tuple of
            positional inputs, such as HSTU's ``(tokens, time_diffs)``).
    """

    def __init__(self, model: torch.nn.Module):
        self.model = model

    def _params_and_buffers(self):
        return dict(self.model.named_parameters()), dict(self.model.named_buffers())

    def export(self, output_path: str, example_input, mode: Optional[str] = None) -> str:
        """Export to ``<output_path>.pt2``; ``mode`` None the full model, ``"user"`` / ``"item"`` one tower."""
        params, buffers = self._params_and_buffers()
        return self._export(output_path, example_input, _Program(self.model, {**params, **buffers}, mode))

    def export_quantized(self, output_path: str, example_input, mode: Optional[str] = None, quant_mode: str = "int8") -> str:
        """Export with the parameters quantized (``quant_mode`` ``"int8"`` or ``"fp16"``) and dequantized in the program."""
        params, buffers = self._params_and_buffers()
        qparams = quantize_params(params, quant_mode, linear_weight_names(self.model))
        return self._export(output_path, example_input, _Program(self.model, {**qparams, **buffers}, mode))

    def _export(self, output_path: str, example_input, program: _Program) -> str:
        device = next(iter(self.model.parameters())).device
        args = _to_tensors(example_input, device)
        args = tuple(args) if isinstance(example_input, (list, tuple)) else (args,)
        was_training = self.model.training
        self.model.eval()
        try:
            exported = torch.export.export(program, args)
        finally:
            self.model.train(was_training)
        base = output_path[: -len(".pt2")] if output_path.endswith(".pt2") else output_path
        os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
        torch.export.save(exported, base + ".pt2")
        return base + ".pt2"


def load_exported(path: str):
    """Load an export of :class:`TorchExporter`; returns ``(callable(x), state)``.

    The callable takes the input structure of the export (numpy arrays or
    tensors) on the program's device and runs the program without autograd;
    ``state`` is the program's buffers by name.  The HSTU attention op is
    registered before the program loads.
    """
    from ..ops.cuda import hstu_rab_attention  # noqa: F401  registers torch.ops.rechub.hstu_rab_fwd

    base = path[: -len(".pt2")] if path.endswith(".pt2") else path
    exported = torch.export.load(base + ".pt2")
    module = exported.module()
    state = dict(exported.state_dict)
    device = next(iter(state.values())).device

    def run(x):
        args = _to_tensors(x, device)
        with torch.no_grad():
            return module(*args) if isinstance(x, (list, tuple)) else module(args)

    return run, state
