"""Carry weights of the JAX package's flax models into the port's modules.

Takes a flax ``params`` tree as nested dicts of numpy arrays (no JAX needed:
``jax.device_get`` of the tree, or arrays from a checkpoint) and loads it
into the port's counterpart module.  The mapping:

- ``Dense.kernel (in, out)`` -> ``Linear.weight (out, in)``; ``Dense.bias`` as is
- ``MultiHeadDotProductAttention``'s ``DenseGeneral`` kernels (BST, SASRec's ``attns_{i}``): ``query``,
  ``key``, ``value`` ``(in, heads, head_dim)`` -> ``Linear.weight (heads·head_dim,
  in)`` with their biases ``(heads, head_dim)`` flattened; ``out`` ``(heads,
  head_dim, out)`` -> ``Linear.weight (out, heads·head_dim)``.  Any other kernel
  of more than two dimensions raises.
- ``LayerNorm.scale`` / ``bias`` -> ``LayerNorm.weight`` / ``bias``
- ``layer_{i}`` -> ``layers.{i}`` (``HSTUBlock``'s ``nn.ModuleList``)
- ``BatchNorm.scale`` / ``bias`` -> ``BatchNorm.weight`` / ``bias``, and its
  ``batch_stats`` ``mean`` / ``var`` -> the buffers ``mean`` / ``var``
- every other leaf (``rab/pos_w``, ``rab/ts_w``, ``token_embedding``,
  ``position_embedding``, ``time_embedding``, ``output_bias``,
  ``output_projection``, ``output_projection_bias``, the embedding tables
  ``{feature}_table`` and ``fused_d{dim}_table``, ``Dice``'s ``alpha``,
  ``PReLU``'s ``slope``, the zoo's raw parameters such as ``w_{i}``'s ``b_{i}``,
  ``conv_w_{i}``, ``gate_w``, ``u_{i}``, the bilinear ``w``, the GRU's and
  AUGRU's matrices, BST's ``pos_embedding``; matching's ``convert_user_weight``,
  the capsule's ``w (1, L, K·D, D)``, ``MultiInterestSA``'s ``W1`` / ``W2``,
  SINE's nine tables and matrices, NARM's ``a_1``, ``a_2``, ``v``, ``b`` and
  ``item_embedding``, STAMP's, SASRec's ``position_emb``) is copied as is.
  flax names a list of submodules ``{attr}_{i}`` (``gru_layers_0``,
  ``attns_1``), and so do the port's models.

The port's modules keep flax's names (``EmbeddingCollection_0``, ``LR_0``,
``MLP_0/Dense_0``, ``MLP_0/BatchNorm_0``, ...), so no other renaming is needed.

RQ-VAE's codebooks ``rq/vq_layers_{i}/embedding`` are raw ``(n_e, e_dim)``
parameters, copied as they are (not transposed as a Dense kernel).

HLLM: ``block_{i}/{W_Q,W_K,W_V,W_O}``, ``block_{i}/Dense_{0,1}`` (Dense
kernels and biases), ``block_{i}/{norm1,norm2}/{scale,bias}``, and the raw
``position_embedding``, ``time_embedding`` and
``rel_pos_bias/rel_pos_bias_table``; its frozen table is the ``constants``
collection's ``item_embeddings`` (``load_flax_params(..., constants=)``).
TIGER: the raw ``shared_embedding``, ``enc_pos``, ``dec_pos``;
``enc_layers_{i}/{LayerNorm_0, _MHA_0/{q,k,v,o}, LayerNorm_1,
_FFN_0/Dense_{0,1}}``, ``dec_layers_{i}/{LayerNorm_0, self_attn,
LayerNorm_1, cross_attn, LayerNorm_2, _FFN_0}`` (kernels only, LayerNorms
with a ``scale`` only) and ``enc_final_ln`` / ``dec_final_ln``.

A dense JAX ``MTLTrainer``'s state loads by :func:`load_mtl_state`:
``params``, ``batch_stats``, the Adam moments of the model and of UWL's or
GradNorm's ``loss_weight``, the weights themselves, MetaBalance's
``mb_norms`` (in ``tree_leaves`` order, :func:`tree_leaf_names`),
``initial_task_loss`` and the step count.

``proj1``'s output columns keep the reference's q | k | u | v order, which
``HSTULayer`` splits the same way.

:func:`load_optax_adam_state` carries optax's ``ScaleByAdamState`` (``mu``,
``nu``, ``count``) into ``torch.optim.Adam``'s state (``exp_avg``,
``exp_avg_sq``, ``step``) by the same mapping, so a run that took N steps
in the JAX package continues in the port.

A sparse JAX trainer's ``opt_state`` is ``(optax state over the rest,
{table path: (R,) accumulator})``, both keyed by flat path tuples
(``flax.traverse_util.flatten_dict``).  Its Adam moments load into the
port's optimizer over the rest by :func:`load_optax_adam_state`, which
takes nested or flat trees, and its accumulators into the trainer's
``sparse_accums`` by :func:`load_sparse_accumulators`.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

_LAYER = re.compile(r"^layer_(\d+)$")
_QKV = ("query", "key", "value")


def _kernel_to_weight(array: np.ndarray, parent: str) -> np.ndarray:
    """A flax kernel as the ``(out, in)`` weight of the ``nn.Linear`` that stands for it."""
    if array.ndim == 2:
        return array.T
    if array.ndim == 3 and parent in _QKV:  # DenseGeneral (in, heads, head_dim)
        return array.reshape(array.shape[0], -1).T
    if array.ndim == 3 and parent == "out":  # DenseGeneral (heads, head_dim, out)
        return array.reshape(-1, array.shape[-1]).T
    raise ValueError(f"{parent}: no mapping for a kernel of shape {array.shape}")


def nest(tree: Mapping) -> Mapping:
    """A flat ``{path tuple: leaf}`` dict as the nested dict it flattens; any other tree as it is."""
    if not tree or not all(isinstance(k, tuple) for k in tree):
        return tree
    out: Dict[str, Any] = {}
    for path, leaf in tree.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def flax_to_state_dict(params: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flatten a flax params tree (nested, or flat with path-tuple keys) into the port's ``state_dict`` names."""
    params = nest(params)
    out: Dict[str, torch.Tensor] = {}
    for key, value in params.items():
        m = _LAYER.match(key)
        name = f"layers.{m.group(1)}" if m else key
        if isinstance(value, Mapping):
            out.update(flax_to_state_dict(value, f"{prefix}{name}."))
            continue
        array = np.asarray(value)
        parent = prefix[:-1].rsplit(".", 1)[-1]
        if key == "kernel":
            name, array = "weight", _kernel_to_weight(array, parent)
        elif key == "bias" and parent in _QKV and array.ndim == 2:  # DenseGeneral (heads, head_dim)
            array = array.reshape(-1)
        elif key == "scale":
            name = "weight"
        out[f"{prefix}{name}"] = torch.tensor(array)
    return out


def load_flax_params(module: torch.nn.Module, params: Mapping[str, Any], batch_stats: Optional[Mapping[str, Any]] = None, constants: Optional[Mapping[str, Any]] = None) -> torch.nn.Module:
    """Copy a flax ``params`` tree, its ``batch_stats`` where the module has
    BatchNorm buffers, and its ``constants`` collection where the module
    keeps one as buffers (HLLM's ``item_embeddings``), into ``module``
    (every entry, strictly)."""
    state = flax_to_state_dict(params)
    state.update(flax_to_state_dict(batch_stats or {}))
    state.update(flax_to_state_dict(constants or {}))
    module.load_state_dict(state, strict=True)
    return module


def load_optax_adam_state(optimizer: torch.optim.Optimizer, module: torch.nn.Module, mu: Mapping[str, Any], nu: Mapping[str, Any], count) -> torch.optim.Optimizer:
    """Set ``optimizer``'s Adam state for every parameter of ``module`` that
    it steps (all of them, or the rest beside a sparse trainer's tables)
    from optax's first and second moments (trees of numpy arrays, nested or
    flat) and its step count."""
    mu_sd, nu_sd = flax_to_state_dict(mu), flax_to_state_dict(nu)
    stepped = {id(p) for group in optimizer.param_groups for p in group["params"]}
    params = {name: p for name, p in module.named_parameters() if id(p) in stepped}
    if set(mu_sd) != set(params) or set(nu_sd) != set(params):
        raise ValueError(f"Adam moments do not cover the optimizer's parameters: {sorted(set(params) ^ set(mu_sd))}")
    step = float(np.asarray(count))
    for name, p in params.items():
        optimizer.state[p] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": mu_sd[name].to(device=p.device, dtype=p.dtype),
            "exp_avg_sq": nu_sd[name].to(device=p.device, dtype=p.dtype),
        }
    return optimizer


def load_sparse_accumulators(accumulators: Dict[str, torch.Tensor], accums: Mapping[Any, Any]) -> Dict[str, torch.Tensor]:
    """Copy a sparse JAX trainer's row-wise accumulators (``{table path tuple:
    (R,)}``, the second half of its ``opt_state``) into the port trainer's
    ``sparse_accums`` (``{parameter name: (R,)}``), every table, in place."""
    src = flax_to_state_dict(accums)
    if set(src) != set(accumulators):
        raise ValueError(f"accumulators do not cover the sparse tables: {sorted(set(src) ^ set(accumulators))}")
    for name, acc in accumulators.items():
        acc.copy_(src[name].to(device=acc.device, dtype=acc.dtype))
    return accumulators


def tree_leaf_names(params: Mapping[str, Any]) -> List[str]:
    """The port's names of a flax ``params`` tree's leaves (nested, or flat with path-tuple keys) in
    ``jax.tree_util.tree_leaves`` order: dict keys sorted at every level."""
    names: List[str] = []

    def walk(node, path):
        if isinstance(node, Mapping):
            for key in sorted(node):
                walk(node[key], path + (key,))
        else:
            names.extend(flax_to_state_dict({path: node}))

    walk(nest(params), ())
    return names


def load_mtl_state(trainer, params: Mapping[str, Any], batch_stats: Optional[Mapping[str, Any]] = None, mu: Optional[Mapping[str, Any]] = None, nu: Optional[Mapping[str, Any]] = None, count=None,
                   loss_weight=None, mb_norms: Optional[Sequence[Any]] = None, initial_task_loss=None, step=None):
    """Carry a dense JAX ``MTLTrainer``'s state into the port's ``MTLTrainer``, in place: ``params`` and
    ``batch_stats``; optax's Adam moments ``mu`` / ``nu`` of its trainable tree ``{"model": ..., "loss_weight":
    ...}`` and their ``count``; ``loss_weight``; ``mb_norms``, a tuple of ``(n_task,)`` arrays in ``tree_leaves``
    order of ``params``; ``initial_task_loss``; the step count.  What is not given is left as it is."""
    load_flax_params(trainer.model, params, batch_stats)
    if mu is not None:
        load_optax_adam_state(trainer.optimizer, trainer.model, mu["model"], nu["model"], count)
        if "loss_weight" in mu:
            lw = trainer.loss_weight
            trainer.optimizer.state[lw] = {
                "step": torch.tensor(float(np.asarray(count)), dtype=torch.float32),
                "exp_avg": torch.tensor(np.asarray(mu["loss_weight"]), dtype=lw.dtype, device=lw.device),
                "exp_avg_sq": torch.tensor(np.asarray(nu["loss_weight"]), dtype=lw.dtype, device=lw.device),
            }

    def put(dst, src):
        dst.copy_(torch.tensor(np.asarray(src), dtype=dst.dtype, device=dst.device))

    with torch.no_grad():
        if loss_weight is not None:
            put(trainer.loss_weight, loss_weight)
        if mb_norms is not None:
            names = tree_leaf_names(params)
            if set(names) != set(trainer.mb_norms) or len(names) != len(mb_norms):
                raise ValueError(f"mb_norms do not cover the model's parameters: {sorted(set(names) ^ set(trainer.mb_norms))}")
            for name, norms in zip(names, mb_norms):
                put(trainer.mb_norms[name], norms)
        if initial_task_loss is not None:
            put(trainer.initial_task_loss, initial_task_loss)
    if step is not None:
        trainer.step = int(np.asarray(step))
    return trainer
