"""Plain PyTorch DeepFM (arXiv:1703.04247): the forward, the loss, and the training update.

One table per categorical field, read by indexing, in float32, with no
fused layout, hooks or recorder.  The model, as the configuration states:

- the linear term: one weight per element of the categorical fields'
  embeddings (the fields' ``(B, F*D)`` concat), plus a bias;
- FM: ``0.5 * sum_d((sum_f e)^2 - sum_f e^2)``;
- the MLP over the categorical embeddings then the dense values:
  ``Linear -> BatchNorm -> ReLU`` per hidden width, then ``Linear(1)``; the
  BatchNorm of training normalises by the batch's mean and biased variance
  ``E[x^2] - E[x]^2`` (eps 1e-5);
- the loss: binary cross-entropy on the summed logit, weighed by the rows'
  weights.

The update: row-wise Adagrad (``reference/optim.py``) on the fields whose
tables are at least ``sparse_min_rows`` long, Adam with weight decay on
every other leaf.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from .optim import adam_step, rowwise_adagrad_step


def batch_norm(x, w, b):
    mean = x.mean(0)
    var = torch.clamp_min((x * x).mean(0) - mean * mean, 0.0)
    return (x - mean) * torch.rsqrt(var + 1e-5) * w + b


def logits(w: Dict[str, torch.Tensor], batch: dict, cfg: dict) -> torch.Tensor:
    fields = len(cfg["cardinalities"])
    emb = torch.stack([w[f"C{i}"][batch[f"C{i}"].to(torch.int64)] for i in range(fields)], dim=1)  # (B, F, D)
    flat = emb.reshape(emb.shape[0], -1)
    dense = torch.stack([batch[f"I{i}"] for i in range(cfg["n_dense"])], dim=1)
    y_linear = F.linear(flat, w["lr.weight"], w["lr.bias"])
    y_fm = 0.5 * (emb.sum(1) ** 2 - (emb * emb).sum(1)).sum(1, keepdim=True)
    x = torch.cat([flat, dense], dim=1)
    for i in range(len(cfg["mlp_dims"])):
        x = torch.relu(batch_norm(F.linear(x, w[f"mlp.{i}.weight"], w[f"mlp.{i}.bias"]), w[f"mlp.{i}.bn_weight"], w[f"mlp.{i}.bn_bias"]))
    y_deep = F.linear(x, w["mlp.out.weight"], w["mlp.out.bias"])
    return (y_linear + y_fm + y_deep)[:, 0]


def bce(z: torch.Tensor, y: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    loss = torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-z.abs()))
    return (loss * weight).sum() / torch.clamp_min(weight.sum(), 1e-12)


def sparse_fields(cfg: dict) -> List[str]:
    return [f"C{i}" for i, rows in enumerate(cfg["cardinalities"]) if rows >= cfg["sparse_min_rows"]]


def train(weights: Dict[str, torch.Tensor], batches: List[dict], cfg: dict) -> dict:
    """Run ``len(batches)`` training steps from ``weights`` (changed in place); see ``reference/hstu.py:train``."""
    sparse = set(sparse_fields(cfg))
    adam_state = {}
    accums = {n: torch.zeros(weights[n].shape[0], device=weights[n].device) for n in sparse}
    losses, first = [], {}
    for step, batch in enumerate(batches, start=1):
        params = {n: t.detach().requires_grad_() for n, t in weights.items()}
        loss = bce(logits(params, batch, cfg), batch["label"], batch["weight"])
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        del params
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for n, g in grads.items():
                if n in sparse:
                    rowwise_adagrad_step(weights[n], accums[n], g, cfg["lr"])
                else:
                    g = adam_step(weights[n], g, adam_state.setdefault(n, {}), step, cfg["lr"], cfg["weight_decay"])
                if step == 1:
                    first[n] = float(torch.linalg.vector_norm(g))
        del grads
    return {"losses": losses, "first_grad_norms": first}
