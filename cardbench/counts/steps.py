"""Model FLOPs of one training step or one served request, counted from shapes.

Only the products count, over the positions that hold an item (padding does
not count): the layers' projections, the attention over its
valid pairs, the sampled softmax's candidate logits, the scoring product, and
for DeepFM the MLP and the linear term.  A backward costs twice its forward
(the input and the weight gradients of each product; for the attention dS
and dV, then dQ and dK).  Recomputation inside a kernel does not count, nor
do elementwise work, normalisations, gathers and optimizers.
"""

from __future__ import annotations


def hstu_forward_flops(cfg: dict, tokens: int, pairs: int) -> float:
    """The layers' forward over ``tokens`` valid positions with ``pairs`` valid (query, key) pairs a head."""
    d, h, dqk, dv = cfg["d_model"], cfg["n_heads"], cfg["dqk"], cfg["dv"]
    proj1 = 2 * tokens * d * (2 * h * dqk + 2 * h * dv)
    proj2 = 2 * tokens * h * dv * d
    attention = 2 * h * pairs * (dqk + dv)
    return cfg["n_layers"] * (proj1 + proj2 + attention)


def hstu_train_step_flops(cfg: dict, tokens: int, pairs: int) -> float:
    """Forward and backward of the layers and of the sampled softmax (each valid position's label and shared negative logits)."""
    sampled = 2 * tokens * cfg["d_model"] * (cfg["num_negatives"] + 1)
    return 3 * (hstu_forward_flops(cfg, tokens, pairs) + sampled)


def hstu_serve_request_flops(cfg: dict, users: int, tokens: int, pairs: int) -> float:
    """The layers' forward over the users' histories, then every item scored for each user's last position."""
    return hstu_forward_flops(cfg, tokens, pairs) + 2 * users * cfg["vocab_size"] * cfg["d_model"]


def deepfm_example_flops(cfg: dict) -> float:
    """One impression's forward and backward: the MLP over the deep input and the linear term over the FM input."""
    n_sparse, n_dense, dim = len(cfg["cardinalities"]), cfg["n_dense"], cfg["embed_dim"]
    widths = [n_sparse * dim + n_dense, *cfg["mlp_dims"], 1]
    mlp = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    linear = n_sparse * dim
    return 3 * 2 * (mlp + linear)
