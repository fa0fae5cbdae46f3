"""The multi-task models and RQ-VAE on the card against the port on the CPU, and the builders the
CPU parity tests share.

The card tests need a CUDA device and skip without one.  This module
imports torch and numpy only, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_mtl.py

For each of the five multi-task classes (the configurations of
``tests/test_e2e_multitask.py``, dropout 0): eval and train outputs and
the BatchNorm statistics, then one ``MTLTrainer`` step (the task losses,
gradients, parameters after Adam); MMOE under UWL, GradNorm and
MetaBalance (the loss weights, MetaBalance's norms); one ``RQVAETrainer``
step and the codes, and the Sinkhorn overflow at epsilon 0.003; the card
against the CPU from the same seeded weights.  No kernel of the port's own
lies on these paths.
"""

import numpy as np
import pytest
import torch

from test_torch_cuda_ranking import LOSS_ATOL, LOSS_RTOL, STATS_ATOL, STATS_RTOL, check_step, ratio
from torch_rechub_tpu_torch.basic import features as tfeat
from torch_rechub_tpu_torch.models import multi_task as tmt
from torch_rechub_tpu_torch.models.generative import rqvae as trq
from torch_rechub_tpu_torch.trainers import MTLTrainer, RQVAETrainer
from torch_rechub_tpu_torch.utils.data import ArrayLoader

# tests/test_e2e_multitask.py:13-44: 4 sparse fields of 30 ids at d6 and one dense field
MTL_MODELS = ("SharedBottom", "ESMM", "MMOE", "PLE", "AITM")
VOCAB, DIM = 30, 6
TASK_TYPES = ("classification", "classification")
# fp32 sums, BatchNorm and softmax gates in another order on each side
OUT_RTOL, OUT_ATOL = 1e-5, 1e-6
BATCH = 64
# tests/test_rqvae.py:10-17
IN_DIM, E_DIM = 32, 8


# ---------------------------------------------------------------------------
# builders: one function for both packages (``mt`` and ``feat`` are either
# package's modules; ``kw`` goes to the port's constructors only)
# ---------------------------------------------------------------------------

def mtl_features(feat):
    return tuple(feat.SparseFeature(f"C{i}", vocab_size=VOCAB, embed_dim=DIM) for i in range(4)) + (feat.DenseFeature("I0"),)


def build_mtl(mt, feat, name, dropout=0.0, **kw):
    """The configurations of ``tests/test_e2e_multitask.py::build``; ``PLE:one_level`` is PLE with one CGC
    level (no shared gate), as the multi-task defaults run it."""
    feats = mtl_features(feat)
    towers = ({"dims": (8,), "dropout": dropout}, {"dims": (8,), "dropout": dropout})
    hidden = {"dims": (16,), "dropout": dropout}
    if name == "SharedBottom":
        return mt.SharedBottom(features=feats, task_types=TASK_TYPES, bottom_params=hidden, tower_params_list=towers, **kw)
    if name == "MMOE":
        return mt.MMOE(features=feats, task_types=TASK_TYPES, n_expert=3, expert_params=hidden, tower_params_list=towers, **kw)
    if name in ("PLE", "PLE:one_level"):
        return mt.PLE(features=feats, task_types=TASK_TYPES, n_level=1 if name == "PLE:one_level" else 2, n_expert_specific=2, n_expert_shared=1, expert_params=hidden, tower_params_list=towers, **kw)
    if name == "AITM":
        return mt.AITM(features=feats, n_task=2, bottom_params=hidden, tower_params_list=towers, **kw)
    if name in ("ESMM", "ESMM:dense"):  # ESMM:dense gives it the dense field too, which its towers leave out
        return mt.ESMM(user_features=feats[:2], item_features=feats[2:] if name == "ESMM:dense" else feats[2:4], cvr_params=towers[0], ctr_params=towers[1], **kw)
    raise KeyError(name)


def task_types_of(name):
    return ("classification",) * 3 if name.startswith("ESMM") else TASK_TYPES


def mtl_frame(n, seed=0, esmm=False):
    """``tests/test_e2e_multitask.py::mtl_data``: uniform ids, a normal dense field, two random 0/1 tasks
    (ESMM: cvr, ctr and ctcvr = cvr · ctr)."""
    rng = np.random.default_rng(seed)
    x = {f"C{i}": rng.integers(0, VOCAB, n).astype(np.int32) for i in range(4)}
    x["I0"] = rng.normal(size=n).astype(np.float32)
    ys = rng.integers(0, 2, (n, 2)).astype(np.float32)
    if esmm:
        ys = np.concatenate([ys, ys[:, :1] * ys[:, 1:2]], axis=1)
    return x, ys


def embeddings(n=300, seed=0):
    """``tests/test_rqvae.py::embeddings``: 10 clusters in IN_DIM, so quantization is learnable."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(10, IN_DIM)) * 3
    return (centers[rng.integers(0, 10, n)] + rng.normal(size=(n, IN_DIM)) * 0.1).astype(np.float32)


def build_rqvae(rq, **kw):
    """``tests/test_rqvae.py``'s model: two stages of 32 codes, the second's Sinkhorn at 0.003."""
    return rq.RQVAEModel(in_dim=IN_DIM, num_emb_list=(32, 32), e_dim=E_DIM, layers=(16,), sk_epsilons=(0.0, 0.003), kmeans_iters=3, **kw)


@torch.no_grad()
def redraw_tables(model, seed, std=0.3):
    """Every embedding table redrawn at N(0, std²) (a fresh model's 1e-4 tables leave every output near its
    BatchNorm's shift)."""
    g = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith("_table"):
            p.copy_(std * torch.randn(p.shape, generator=g))
    return model


# ---------------------------------------------------------------------------
# the card against the CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def pair(name, device, seed=0):
    cpu = redraw_tables(build_mtl(tmt, tfeat, name, generator=torch.Generator().manual_seed(seed)), seed)
    dev = build_mtl(tmt, tfeat, name, device=device)
    dev.load_state_dict({k: v.to(device) for k, v in cpu.state_dict().items()})
    return cpu, dev


@pytest.mark.cuda
@pytest.mark.parametrize("name", MTL_MODELS)
def test_mtl_forward_on_the_card_matches_the_cpu(card, name):
    cpu, dev = pair(name, card)
    x, _ = mtl_frame(BATCH, seed=1)
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    for mode in ("eval", "train"):
        ref, got = getattr(cpu, mode)()(tx).detach(), getattr(dev, mode)()({k: v.to(card) for k, v in tx.items()}).detach().cpu()
        assert got.shape == (BATCH, len(task_types_of(name))) and torch.isfinite(got).all()
        assert ratio(got, ref, OUT_RTOL, OUT_ATOL) <= 1.0, mode
    for (key, a), b in zip(cpu.named_buffers(), dev.buffers(), strict=True):
        assert ratio(b.cpu(), a, STATS_RTOL, STATS_ATOL) <= 1.0, key


def step_on_both(name, device, adaptive=None, seed=2):
    """One MTLTrainer step on a partial batch from the same weights, on the CPU and on ``device``."""
    cpu, dev = pair(name, device, seed=seed)
    x, ys = mtl_frame(BATCH - 14, seed=3, esmm=name == "ESMM")
    before = {k: v.detach().numpy().copy() for k, v in cpu.named_parameters()}
    trainers = [MTLTrainer(m, task_types_of(name), optimizer_params={"lr": 1e-3, "weight_decay": 1e-5}, adaptive_params=adaptive, device=d) for m, d in ((cpu, "cpu"), (dev, device))]
    losses = [t.train_one_epoch(ArrayLoader(x, ys, batch_size=BATCH), log_interval=0) for t in trainers]
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses[1], losses[0], rtol=LOSS_RTOL, atol=LOSS_ATOL)
    check_step({k: p.grad.cpu().numpy() for k, p in dev.named_parameters()}, {k: p.detach().cpu().numpy() for k, p in dev.named_parameters()},
               {k: p.grad.numpy() for k, p in cpu.named_parameters()}, {k: p.detach().numpy() for k, p in cpu.named_parameters()}, before, BATCH)
    return trainers


@pytest.mark.cuda
@pytest.mark.parametrize("name", MTL_MODELS)
def test_mtl_train_step_on_the_card_matches_the_cpu(card, name):
    step_on_both(name, card)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ("uwl", "gradnorm", "metabalance"))
def test_adaptive_step_on_the_card_matches_the_cpu(card, method):
    ref, got = step_on_both("MMOE", card, adaptive={"method": method})
    if method != "metabalance":
        np.testing.assert_allclose(got.loss_weight.detach().cpu().numpy(), ref.loss_weight.detach().numpy(), rtol=1e-6, atol=1e-7)
    else:
        for name, norms in ref.mb_norms.items():
            np.testing.assert_allclose(got.mb_norms[name].cpu().numpy(), norms.numpy(), rtol=1e-4, atol=1e-7, err_msg=name)


def codes_match_up_to_ties(cpu, dev, data):
    """The nearest codes of every row on ``dev`` against the CPU's from the same weights: a differing code
    is an argmin tie, the CPU's distances to the two codes within 1e-5 of each other (relative, plus 1e-6).
    Returns the number of ties."""
    x = torch.from_numpy(data)
    with torch.no_grad():
        got, ref = dev.eval().get_indices(x.to(dev.rq.vq_layers_0.embedding.device)).cpu(), cpu.eval().get_indices(x)
        residual, ties = cpu.encode(x), 0
        for i in range(ref.shape[1]):
            emb = getattr(cpu.rq, f"vq_layers_{i}").embedding
            d = (residual**2).sum(1, keepdim=True) + (emb**2).sum(1)[None, :] - 2 * residual @ emb.T
            bad = torch.nonzero(got[:, i] != ref[:, i]).reshape(-1)
            gap = (d[bad, got[bad, i]] - d[bad, ref[bad, i]]).abs()
            assert (gap <= 1e-5 * d[bad, ref[bad, i]].abs() + 1e-6).all(), i
            ties += int(bad.numel())
            residual = residual - emb[ref[:, i]]
    return ties


@pytest.mark.cuda
def test_rqvae_step_and_codes_on_the_card_match_the_cpu(card):
    """One RQVAETrainer step (loss, gradients, parameters after Adam) from the same weights, then the
    nearest codes of every row from the CPU's weights after the step (argmin ties aside)."""
    cpu = build_rqvae(trq, generator=torch.Generator().manual_seed(0))
    dev = build_rqvae(trq, device=card)
    dev.load_state_dict({k: v.to(card) for k, v in cpu.state_dict().items()})
    data = embeddings(256)
    before = {k: v.detach().numpy().copy() for k, v in cpu.named_parameters()}
    trainers = [RQVAETrainer(m, n_epoch=1, use_sk=False, device=d) for m, d in ((cpu, "cpu"), (dev, card))]
    losses = [t.train_one_epoch(data, batch_size=256) for t in trainers]  # one step
    np.testing.assert_allclose(losses[1], losses[0], rtol=LOSS_RTOL, atol=LOSS_ATOL)
    check_step({k: p.grad.cpu().numpy() for k, p in dev.named_parameters()}, {k: p.detach().cpu().numpy() for k, p in dev.named_parameters()},
               {k: p.grad.numpy() for k, p in cpu.named_parameters()}, {k: p.detach().numpy() for k, p in cpu.named_parameters()}, before, 256)
    dev.load_state_dict({k: v.to(card) for k, v in cpu.state_dict().items()})
    assert codes_match_up_to_ties(cpu, dev, data) < len(data) // 10  # all ties, and few


@pytest.mark.cuda
def test_sinkhorn_overflow_on_the_card(card):
    """At epsilon 0.003 the plan is NaN everywhere on the card too, and argmax gives code 0; at 0.05 it is
    finite and within fp32 rounding of the CPU's."""
    d = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 256)).astype(np.float32))
    q = trq.sinkhorn_algorithm(trq.center_distances(d.to(card)), 0.003, 100)
    assert torch.isnan(q).all() and (q.argmax(-1) == 0).all()
    q = trq.sinkhorn_algorithm(trq.center_distances(d.to(card)), 0.05, 100).cpu()
    assert ratio(q, trq.sinkhorn_algorithm(trq.center_distances(d), 0.05, 100), 1e-4, 1e-9) <= 1.0
