"""The port's DeepFM / CTRTrainer path on the card, against the port on the CPU.

These tests need a CUDA device and skip without one.  They import torch and
numpy only, so they also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_ctr.py

The CPU side is the port itself, which ``tests/test_torch_ctr_*.py`` hold
against the JAX package.  No kernel of the port's own lies on this path: it
runs PyTorch's gathers, scatter-adds, matrix products and Adam.
"""

import numpy as np
import pytest
import torch

from torch_rechub_tpu_torch.basic.features import DenseFeature, SparseFeature
from torch_rechub_tpu_torch.models.ranking import DeepFM
from torch_rechub_tpu_torch.ops import embedding as temb
from torch_rechub_tpu_torch.trainers import CTRTrainer
from torch_rechub_tpu_torch.utils.data import ArrayLoader, DeviceCachedLoader

pytestmark = pytest.mark.cuda

N_SPARSE, N_DENSE, VOCAB, DIM, BIG, BATCH = 26, 13, 1000, 16, 300_000, 512
MLP_PARAMS = {"dims": (256, 128), "dropout": 0.0, "activation": "relu"}
# fp32 sums of up to 429 products and BatchNorm, in cuBLAS's order against the CPU's
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 1e-6
# one step: the tolerances of the CPU parity tests (tests/test_torch_ctr_train.py)
LOSS_RTOL, LOSS_ATOL = 2e-5, 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 2e-4, 1e-4
ADAM_RTOL, ADAM_UPDATE_TOL = 1e-6, 3e-5
STATS_RTOL, STATS_ATOL = 1e-5, 1e-6
# the Dense biases in front of a BatchNorm: the loss gives them an exact gradient of 0,
# both devices' are rounding noise below this share of the model's largest gradient
BN_INVARIANT, NOISE_REL = ("MLP_0.Dense_0.bias", "MLP_0.Dense_1.bias"), 1e-6
LR, WD = 1e-3, 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(params=["auto", False, True], ids=["auto", "per_feature", "fused"])
def layout(request):
    old = temb.set_fused_default(request.param)
    yield request.param
    temb.set_fused_default(old)


def features():
    sparse = tuple(SparseFeature(f"C{i}", VOCAB, DIM) for i in range(N_SPARSE)) + (SparseFeature("C_big", BIG, DIM),)
    return sparse, tuple(DenseFeature(f"I{i}") for i in range(N_DENSE))


def data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = {f"C{i}": rng.integers(0, VOCAB, n).astype(np.int32) for i in range(N_SPARSE)}
    x["C_big"] = rng.integers(0, BIG, n).astype(np.int32)
    x.update({f"I{i}": rng.normal(size=n).astype(np.float32) for i in range(N_DENSE)})
    return x, rng.integers(0, 2, n).astype(np.float32)


def models(device, seed=0):
    """The same seeded DeepFM on the CPU and on ``device`` (deep: dense + sparse, fm: sparse)."""
    sparse, dense = features()
    cpu = DeepFM(dense + sparse, sparse, MLP_PARAMS, generator=torch.Generator().manual_seed(seed))
    dev = DeepFM(dense + sparse, sparse, MLP_PARAMS, generator=torch.Generator().manual_seed(seed), device=device)
    for (name, a), b in zip(cpu.state_dict().items(), dev.state_dict().values(), strict=True):
        assert b.device.type == device.type and torch.equal(a, b.cpu()), name
    return cpu, dev


def ratio(got, ref, rtol, atol):
    return float(((got - ref).abs() / (atol + rtol * ref.abs())).max())


def test_deepfm_forward_on_the_card_matches_the_cpu(card, layout):
    cpu, dev = models(card)
    if layout is not False:
        assert dev.EmbeddingCollection_0.fused_d16_table.is_cuda
    x, _ = data(BATCH, seed=1)
    x["C_big"][:4] = [0, BIG - 1, BIG // 2, 1]
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    dx = {k: v.to(card) for k, v in tx.items()}
    for mode in ("eval", "train"):
        ref = getattr(cpu, mode)()(tx).detach()
        got = getattr(dev, mode)()(dx).detach().cpu()
        assert got.shape == (BATCH,) and torch.isfinite(got).all()
        assert ratio(got, ref, LOGIT_RTOL, LOGIT_ATOL) <= 1.0, mode
    for (name, a), b in zip(cpu.named_buffers(), dev.buffers(), strict=True):  # the train forward's BatchNorm statistics
        assert ratio(b.cpu(), a, STATS_RTOL, STATS_ATOL) <= 1.0, name


def adam_first_update(g, p0):
    g = g.double() + WD * p0.double()
    return g / (g.abs() + 1e-8)


def test_train_step_on_the_card_matches_the_cpu(card):
    """One CTRTrainer step on a partial batch (padded by cycling rows, weight 0): the loss, every
    gradient, every parameter after Adam and the BatchNorm statistics, the card against the CPU.
    Adam's first step is about lr * sign(g), so a parameter is also allowed what the update rule
    makes of the two gradients' difference."""
    cpu, dev = models(card, seed=2)
    x, y = data(BATCH - 100, seed=3)
    p0 = {k: v.detach().clone() for k, v in cpu.named_parameters()}
    losses = [CTRTrainer(m, optimizer_params={"lr": LR, "weight_decay": WD}, device=d).train_one_epoch(ArrayLoader(x, y, batch_size=BATCH), log_interval=0)
              for m, d in ((cpu, "cpu"), (dev, card))]
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses[1], losses[0], rtol=LOSS_RTOL, atol=LOSS_ATOL)
    named = dict(dev.named_parameters())
    floor = NOISE_REL * max(float(p.grad.abs().max()) for p in cpu.parameters())
    for name, p in cpu.named_parameters():
        g, r = named[name].grad.cpu(), p.grad
        if name in BN_INVARIANT:
            assert float(g.abs().max()) < floor and float(r.abs().max()) < floor, name
        else:
            assert ratio(g, r, GRAD_RTOL, GRAD_ATOL_REL * float(r.abs().max()) + 1e-12) <= 1.0, name
        carried = LR * (adam_first_update(g, p0[name]) - adam_first_update(r, p0[name])).abs()
        got, ref = named[name].detach().cpu().double(), p.detach().double()
        assert bool(((got - ref).abs() <= ADAM_UPDATE_TOL * LR + ADAM_RTOL * ref.abs() + carried).all()), name
        assert not torch.equal(got.float(), p0[name]) or not r.any(), name  # every parameter with a gradient moved
    for (name, a), b in zip(cpu.named_buffers(), dev.buffers(), strict=True):
        assert ratio(b.cpu(), a, STATS_RTOL, STATS_ATOL) <= 1.0, name


def test_device_cached_loader_groups_on_the_card(card):
    x, y = data(1000, seed=4)
    loader = DeviceCachedLoader(x, y, batch_size=128, group_size=3, shuffle=True, seed=5)
    assert loader.device.type == "cuda" and len(loader) == 9
    seen = []
    for xs, ys, ws in loader.device_groups():
        assert ys.is_cuda and ws.is_cuda and all(v.is_cuda for v in xs.values())
        assert ys.shape == ws.shape == (3, 128) and xs["C0"].dtype == torch.int32 and xs["I0"].dtype == torch.float32
        seen.append((xs["C0"].cpu().numpy().ravel(), ys.cpu().numpy().ravel(), ws.cpu().numpy().ravel()))
    ids, labels, weights = (np.concatenate(a) for a in zip(*seen))
    assert weights.sum() == 1000 and len(weights) == 9 * 128
    real = weights > 0  # the shuffle moves whole groups; the real rows are all there once
    order = np.lexsort((labels[real], ids[real]))
    ref = np.lexsort((y, x["C0"]))
    np.testing.assert_array_equal(ids[real][order], x["C0"][ref])
    np.testing.assert_array_equal(labels[real][order], y[ref])


def test_device_cached_loader_trains_as_the_array_loader_on_the_card(card):
    """Two epochs of 512-row batches: the loader on the card and the host loader give the same
    losses and weights (the same steps on the same device)."""
    x, y = data(4 * BATCH, seed=6)
    runs = []
    for loader in (ArrayLoader(x, y, batch_size=BATCH), DeviceCachedLoader(x, y, batch_size=BATCH, group_size=2)):
        _, dev = models(card, seed=7)
        trainer = CTRTrainer(dev)
        runs.append(([trainer.train_one_epoch(loader, log_interval=0) for _ in range(2)], {k: v.cpu() for k, v in dev.state_dict().items()}))
    (ref_losses, ref_state), (losses, state) = runs
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-6)
    for name, v in state.items():
        assert torch.allclose(v, ref_state[name], rtol=1e-5, atol=1e-6) or name in BN_INVARIANT, name
