"""RQ-VAE, the residual-quantized VAE that gives items their semantic ids (TIGER).

Counterpart of ``torch_rechub_tpu/models/generative/rqvae.py``: an MLP
encoder, stage-wise residual vector quantization (straight-through, a
Sinkhorn assignment where a stage's ``sk_epsilon`` is above 0), an MLP
decoder.  The encoder and decoder are the layer zoo's ``MLP`` (a BatchNorm
in every layer, the decoder's output through its ReLU too), as in the JAX
package.  The codebooks start at ``U(−1/n_e, 1/n_e)``;
:func:`kmeans_init_codebooks` replaces them stage by stage from the
residuals of a data sample, by the numpy k-means of the JAX package with
the same ``default_rng(seed + i)`` draws.

Sinkhorn runs in fp32 as there.  At a small epsilon (0.003, the retry
setting of ``RQVAETrainer.generate_semantic_ids``) ``exp(−d/ε)`` of the
centred distances overflows, every entry of the plan becomes NaN and
``argmax`` returns code 0 for every row: a quirk of the reference that the
port keeps (``ROADMAP.md`` queue 3).

Inside a training step under a device mesh (``parallel.distributed.data_parallel``)
each rank holds its rows of the global batch, and every reduction over the
batch is the global batch's, as in the JAX package's single program: the
quantizers' and the reconstruction's means (``mean_over_batch``), and
Sinkhorn's balance: the largest and smallest distance of
:func:`center_distances`, the plan's total and column sums, and the batch
size ``b`` are taken over the data group (a row's sum stays the rank's).
Outside a scope (evaluation, ``generate_semantic_ids``) nothing is gathered.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ...basic.initializers import param
from ...basic.layers import MLP
from ...parallel import distributed as pdist
from ...parallel.distributed import mean_over_batch


def _batch_group():
    """The data group of the open ``data_parallel`` scope when it holds more than one rank, else None."""
    group = pdist.data_group()
    return None if group is None or pdist.group_size(group) == 1 else group


def sinkhorn_algorithm(distances: torch.Tensor, epsilon: float, iterations: int) -> torch.Tensor:
    """The entropy-regularized balanced assignment of ``(B, K)`` distances (this rank's rows of the global
    batch inside a ``data_parallel`` scope: the total, the column sums and ``B`` are the global batch's)."""
    group = _batch_group()
    q = torch.exp(-distances / epsilon)
    b, k = q.shape
    if group is None:
        q = q / q.sum()
    else:
        b = b * pdist.group_size(group)
        q = q / pdist.all_reduce(q.sum(), group)
    for _ in range(iterations):
        q = q / q.sum(dim=1, keepdim=True) / b
        cols = q.sum(dim=0, keepdim=True)
        q = q / (cols if group is None else pdist.all_reduce(cols, group)) / k
    return q * b


def center_distances(d: torch.Tensor) -> torch.Tensor:
    """Distances normalised to [-1, 1] by their middle and half range (plus 1e-5); the global batch's largest and
    smallest inside a ``data_parallel`` scope."""
    group = _batch_group()
    if group is None:
        mx, mn = d.max(), d.min()
    else:  # one collective: the max of (max, -min)
        mx, neg_mn = pdist.all_reduce(torch.stack([d.max(), -d.min()]), group, op=dist.ReduceOp.MAX)
        mn = -neg_mn
    middle = (mx + mn) / 2
    amplitude = mx - middle + 1e-5
    return (d - middle) / amplitude


class VectorQuantizer(nn.Module):
    """One stage: the nearest code (or Sinkhorn's), codebook + ``beta`` · commitment loss, straight-through."""

    def __init__(self, n_e: int, e_dim: int, beta: float = 0.25, sk_epsilon: float = 0.003, sk_iters: int = 100, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.n_e, self.e_dim, self.beta, self.sk_epsilon, self.sk_iters = n_e, e_dim, beta, sk_epsilon, sk_iters
        bound = 1.0 / n_e
        self.embedding = param(lambda shape, g: torch.empty(shape).uniform_(-bound, bound, generator=g), (n_e, e_dim), generator, device)

    def forward(self, x: torch.Tensor, use_sk: bool = True, sk_epsilon: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        emb = self.embedding
        latent = x.reshape(-1, self.e_dim)
        d = (latent**2).sum(1, keepdim=True) + (emb**2).sum(1)[None, :] - 2 * latent @ emb.T
        eps = self.sk_epsilon if sk_epsilon is None else sk_epsilon
        if not use_sk or eps <= 0:
            indices = torch.argmin(d, dim=-1)
        else:
            indices = torch.argmax(sinkhorn_algorithm(center_distances(d.detach()), eps, self.sk_iters), dim=-1)
        x_q = emb[indices].reshape(x.shape)
        commitment = mean_over_batch((x_q.detach() - x) ** 2)
        codebook = mean_over_batch((x_q - x.detach()) ** 2)
        loss = codebook + self.beta * commitment
        x_q = x + (x_q - x).detach()  # straight-through
        return x_q, loss, indices.reshape(x.shape[:-1])


class ResidualVectorQuantizer(nn.Module):
    """Stage-wise residual VQ (SoundStream, arXiv:2107.03312); stages named ``vq_layers_{i}`` as in flax."""

    def __init__(self, n_e_list: Sequence[int], e_dim: int, sk_epsilons: Sequence[float], beta: float = 0.25, sk_iters: int = 100, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.n_stages = len(n_e_list)
        for i, (n_e, eps) in enumerate(zip(n_e_list, sk_epsilons)):
            self.add_module(f"vq_layers_{i}", VectorQuantizer(n_e, e_dim, beta=beta, sk_epsilon=eps, sk_iters=sk_iters, generator=generator, device=device))

    def forward(self, x: torch.Tensor, use_sk: bool = True, sk_epsilon_overrides=None):
        losses, all_indices = [], []
        x_q = 0.0
        residual = x
        for i in range(self.n_stages):
            override = None if sk_epsilon_overrides is None else sk_epsilon_overrides[i]
            x_res, loss, indices = getattr(self, f"vq_layers_{i}")(residual, use_sk=use_sk, sk_epsilon=override)
            residual = residual - x_res
            x_q = x_q + x_res
            losses.append(loss)
            all_indices.append(indices)
        return x_q, torch.stack(losses).mean(), torch.stack(all_indices, dim=-1)


class RQVAEModel(nn.Module):
    """Encoder -> residual VQ -> decoder.  ``forward`` returns ``(reconstruction, rq loss, (B, n_stages) codes)``;
    the module's mode (``train()`` / ``eval()``) sets BatchNorm's and dropout's, as ``training`` does in flax."""

    def __init__(self, in_dim: int = 768, num_emb_list: Sequence[int] = (256, 256, 256), e_dim: int = 64, layers: Sequence[int] = (512, 256, 128), dropout_prob: float = 0.0, bn: bool = False, loss_type: str = "mse", quant_loss_weight: float = 1.0, beta: float = 0.25, kmeans_init: bool = False, kmeans_iters: int = 100, sk_epsilons: Optional[Sequence[float]] = None, sk_iters: int = 100, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.in_dim, self.num_emb_list, self.e_dim, self.layers = in_dim, tuple(num_emb_list), e_dim, tuple(layers)
        self.loss_type, self.quant_loss_weight, self.kmeans_init, self.kmeans_iters = loss_type, quant_loss_weight, kmeans_init, kmeans_iters
        self.sk_epsilons = None if sk_epsilons is None else tuple(sk_epsilons)
        self.bn = bn  # accepted and unused, as in the JAX package: every MLP layer has its BatchNorm
        self.encoder = MLP(in_dim, dims=self.layers + (e_dim,), output_layer=False, dropout=dropout_prob, activation="relu", generator=generator, device=device)
        sk_eps = self.sk_epsilons if self.sk_epsilons is not None else tuple(0.0 for _ in self.num_emb_list)
        self.rq = ResidualVectorQuantizer(self.num_emb_list, e_dim, sk_eps, beta=beta, sk_iters=sk_iters, generator=generator, device=device)
        self.decoder = MLP(e_dim, dims=tuple(reversed(self.layers)) + (in_dim,), output_layer=False, dropout=dropout_prob, activation="relu", generator=generator, device=device)

    def forward(self, x: torch.Tensor, use_sk: bool = True, sk_epsilon_overrides=None, generator: Optional[torch.Generator] = None):
        z = self.encoder(x, generator=generator)
        x_q, rq_loss, indices = self.rq(z, use_sk=use_sk, sk_epsilon_overrides=sk_epsilon_overrides)
        return self.decoder(x_q, generator=generator), rq_loss, indices

    def _eval_encoder(self, x: torch.Tensor) -> torch.Tensor:
        """The encoder in eval mode (running BatchNorm statistics), whatever the module's mode, as flax's ``training=False``."""
        was = self.encoder.training
        self.encoder.eval()
        try:
            return self.encoder(x)
        finally:
            self.encoder.train(was)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self._eval_encoder(x)

    def get_indices(self, x: torch.Tensor, use_sk: bool = False, sk_epsilon_overrides=None) -> torch.Tensor:
        """``(B, n_stages)`` codes of ``x``, the encoder in eval mode."""
        return self.rq(self._eval_encoder(x), use_sk=use_sk, sk_epsilon_overrides=sk_epsilon_overrides)[2]

    def compute_loss(self, out: torch.Tensor, quant_loss: torch.Tensor, xs: torch.Tensor):
        """``(recon + quant_loss_weight · quant_loss, recon)``, recon the MSE or L1 of ``out`` against ``xs``."""
        if self.loss_type == "mse":
            recon = mean_over_batch((out - xs) ** 2)
        elif self.loss_type == "l1":
            recon = mean_over_batch((out - xs).abs())
        else:
            raise ValueError("incompatible loss type")
        return recon + self.quant_loss_weight * quant_loss, recon


# ---------------------------------------------------------------------------
# numpy k-means (the codebooks' explicit init), as in the JAX package
# ---------------------------------------------------------------------------


def _kmeans_pp(x: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    """k-means++ seeding.  Each row's squared distance to its nearest centre is kept and lowered by each new
    centre's: the same values, by the same per-centre sums, as the minimum over every centre drawn so far that
    the JAX package takes at each draw, at O(k·n·d) instead of O(k²·n·d)."""
    centers = [x[rng.integers(len(x))]]
    d2 = ((x - centers[0]) ** 2).sum(-1)
    for _ in range(1, k):
        probs = d2 / max(d2.sum(), 1e-12)
        centers.append(x[rng.choice(len(x), p=probs)])
        d2 = np.minimum(d2, ((x - centers[-1]) ** 2).sum(-1))
    return np.stack(centers)


def _nearest(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """The index of each float64 row's nearest centre by ``((x - c) ** 2).sum(-1)``, the first on a tie, as the JAX
    package takes it.  The distances are expanded as ``|x|² − 2 x·c + |c|²`` (one matrix product); a row whose two
    nearest centres lie within 1e-9 of its scale of each other, far above the two forms' rounding (about 1e-15 of
    it), is decided by the direct form."""
    xx, cc = (x * x).sum(-1), (centers * centers).sum(-1)
    d = xx[:, None] - 2.0 * (x @ centers.T) + cc[None, :]
    nearest = np.argmin(d, axis=1)
    if centers.shape[0] > 1:
        two = np.partition(d, 1, axis=1)
        close = np.nonzero(two[:, 1] - two[:, 0] <= 1e-9 * (xx + cc.max()))[0]
        if close.size:
            nearest[close] = np.argmin(((x[close, None, :] - centers[None]) ** 2).sum(-1), axis=1)
    return nearest


def kmeans(samples: np.ndarray, num_clusters: int, num_iters: int = 10, seed: int = 0) -> np.ndarray:
    """Lloyd's k-means with k-means++ seeding; returns ``(k, d)`` fp32 centres."""
    x = np.asarray(samples, dtype=np.float64)
    if len(x) < num_clusters:
        reps = int(np.ceil(num_clusters / max(len(x), 1)))
        x = np.tile(x, (reps, 1))[:num_clusters]
    rng = np.random.default_rng(seed)
    centers = _kmeans_pp(x, num_clusters, rng)
    for _ in range(num_iters):
        assign = _nearest(x, centers)
        for c in range(num_clusters):
            pts = x[assign == c]
            if len(pts):
                centers[c] = pts.mean(axis=0)
    return centers.astype(np.float32)


@torch.no_grad()
def kmeans_init_codebooks(model: RQVAEModel, data: np.ndarray, num_iters: int = 10, seed: int = 0) -> RQVAEModel:
    """Set each stage's codebook, in place, to the k-means centres (``seed + i``) of the residuals of
    ``data``'s encodings (the encoder in eval mode); returns ``model``."""
    device = model.rq.vq_layers_0.embedding.device
    z = model.encode(torch.as_tensor(np.asarray(data, dtype=np.float32), device=device)).cpu().numpy()
    residual = z.astype(np.float64)
    for i, n_e in enumerate(model.num_emb_list):
        centers = kmeans(residual, n_e, num_iters=num_iters, seed=seed + i)
        getattr(model.rq, f"vq_layers_{i}").embedding.copy_(torch.from_numpy(centers))
        residual = residual - centers[_nearest(residual, centers)]
    return model
