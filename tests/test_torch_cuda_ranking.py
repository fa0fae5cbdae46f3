"""The ranking zoo on the card against the port on the CPU, and the builders
and step check the zoo's CPU parity tests share.

The card tests need a CUDA device and skip without one.  This module
imports torch and numpy only, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_ranking.py

For each of the 14 configurations (the 11 of ``tests/test_e2e_ranking.py``
and DIN, BST, DIEN of ``tests/test_e2e_sequence_ranking.py``, at their
sizes, dropout 0): eval and train logits (DIEN's aux loss too) and the
BatchNorm statistics, then one ``CTRTrainer`` step (loss, gradients,
parameters after Adam), the card against the CPU from the same seeded
weights.  No kernel of the port's own lies on this path.
"""

import re

import numpy as np
import pytest
import torch

from torch_rechub_tpu_torch.basic import features as tfeat
from torch_rechub_tpu_torch.models import ranking as tranking
from torch_rechub_tpu_torch.trainers import CTRTrainer
from torch_rechub_tpu_torch.utils.data import ArrayLoader

CTR_MODELS = ("WideDeep", "DeepFM", "DCN", "DCNv2", "DCNv2_stacked", "EDCN", "AFM", "AutoInt", "FiBiNet", "DeepFFM", "FatDeepFFM")
SEQ_MODELS = ("DIN", "BST", "DIEN")
# the other options of the layers and models, as "Model:option" for build_ctr
VARIANTS = ("DCNv2:crossnet_only", "DCNv2:stacked_mix", "DCNv2:parallel_v2", "EDCN:pointwise_addition", "EDCN:concatenation", "EDCN:attention_pooling",
            "EDCN:no_regulation", "FiBiNet:field_all", "FiBiNet:field_each")
# tests/test_e2e_ranking.py:19-57 and tests/test_e2e_sequence_ranking.py:11-47
N_SPARSE, N_DENSE, VOCAB, DIM = 5, 5, 64, 8
N_ITEMS, SEQ_LEN, EMBED = 50, 10, 8
# fp32 sums of up to 100 products, BatchNorm and softmaxes, in another order on each side
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 1e-6
# one step: the tolerances of tests/test_torch_ctr_train.py
LOSS_RTOL, LOSS_ATOL = 2e-5, 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 2e-4, 1e-4
ADAM_RTOL, ADAM_UPDATE_TOL = 1e-6, 3e-5
STATS_RTOL, STATS_ATOL = 1e-5, 1e-6
# a gradient that is exactly 0 (a bias in front of a BatchNorm) is a sum over the batch's rows
# that cancels: each fp32 add rounds by up to eps of the sum, so both sides' noise lies below
# rows x eps x the model's largest gradient
EPS32 = float(np.finfo(np.float32).eps)
LR, WD = 1e-3, 1e-5
BATCH = 256


# ---------------------------------------------------------------------------
# builders: one function for both packages (``ranking`` and ``feat`` are
# either package's modules; ``kw`` goes to the port's constructors only)
# ---------------------------------------------------------------------------

def ctr_schema(feat):
    sparse = tuple(feat.SparseFeature(f"C{i}", vocab_size=VOCAB, embed_dim=DIM) for i in range(N_SPARSE))
    return sparse, tuple(feat.DenseFeature(f"I{i}") for i in range(N_DENSE))


def build_ctr(ranking, feat, name, dropout=0.0, **kw):
    """The configurations of ``tests/test_e2e_ranking.py::build_model``, and the ``VARIANTS``."""
    sparse, dense = ctr_schema(feat)
    name, _, option = name.partition(":")
    mlp = {"dims": (16, 8), "dropout": dropout, "activation": "relu"}
    if name in ("DeepFFM", "FatDeepFFM"):
        cross = tuple(feat.SparseFeature(f"C{i}", vocab_size=VOCAB * N_SPARSE, embed_dim=DIM) for i in range(N_SPARSE))
        linear = tuple(feat.SparseFeature(f"C{i}", vocab_size=VOCAB, embed_dim=1) for i in range(N_SPARSE))
        if name == "DeepFFM":
            return ranking.DeepFFM(linear_features=linear, cross_features=cross, embed_dim=DIM, mlp_params=mlp, **kw)
        return ranking.FatDeepFFM(linear_features=linear, cross_features=cross, embed_dim=DIM, reduction_ratio=2, mlp_params=mlp, **kw)
    builders = {
        "WideDeep": lambda: ranking.WideDeep(wide_features=dense, deep_features=sparse, mlp_params=mlp, **kw),
        "DeepFM": lambda: ranking.DeepFM(deep_features=dense, fm_features=sparse, mlp_params=mlp, **kw),
        "DCN": lambda: ranking.DCN(features=sparse + dense, n_cross_layers=2, mlp_params=mlp, **kw),
        "DCNv2": lambda: ranking.DCNv2(features=sparse + dense, n_cross_layers=2, mlp_params=mlp, low_rank=4, num_experts=2, **kw),
        "DCNv2:crossnet_only": lambda: ranking.DCNv2(features=sparse + dense, n_cross_layers=2, mlp_params=mlp, model_structure="crossnet_only", low_rank=4, num_experts=2, **kw),
        "DCNv2:stacked_mix": lambda: ranking.DCNv2(features=sparse + dense, n_cross_layers=2, mlp_params=mlp, model_structure="stacked", low_rank=4, num_experts=3, **kw),
        "DCNv2:parallel_v2": lambda: ranking.DCNv2(features=sparse + dense, n_cross_layers=3, mlp_params=mlp, use_low_rank_mixture=False, **kw),
        "DCNv2_stacked": lambda: ranking.DCNv2(features=sparse + dense, n_cross_layers=2, mlp_params=mlp, model_structure="stacked", use_low_rank_mixture=False, **kw),
        "EDCN": lambda: ranking.EDCN(features=sparse, n_cross_layers=2, mlp_params=dict(mlp), **kw),
        "EDCN:no_regulation": lambda: ranking.EDCN(features=sparse, n_cross_layers=2, mlp_params=dict(mlp), use_regulation_module=False, **kw),
        "AFM": lambda: ranking.AFM(fm_features=sparse, embed_dim=DIM, t=16, **kw),
        "AutoInt": lambda: ranking.AutoInt(sparse_features=sparse, dense_features=dense, num_layers=2, mlp_params=mlp, **kw),
        "FiBiNet": lambda: ranking.FiBiNet(features=sparse, mlp_params=mlp, **kw),
    }
    if name == "EDCN" and option not in ("", "no_regulation"):
        return ranking.EDCN(features=sparse, n_cross_layers=3, mlp_params=dict(mlp), bridge_type=option, temperature=0.5, **kw)
    if name == "FiBiNet" and option:
        return ranking.FiBiNet(features=sparse, mlp_params=mlp, bilinear_type=option, reduction_ratio=2, **kw)
    return builders[f"{name}:{option}" if option else name]()


def ctr_frame(n, seed=2022):
    """``conftest.synthetic_ctr_frame``'s data: uniform ids, normal dense values, random labels."""
    rng = np.random.default_rng(seed)
    x = {f"C{i}": rng.integers(0, VOCAB, n).astype(np.int32) for i in range(N_SPARSE)}
    x.update({f"I{i}": rng.normal(size=n).astype(np.float32) for i in range(N_DENSE)})
    return x, rng.integers(0, 2, n).astype(np.float32)


def seq_schema(feat):
    """(profile, history, negative history, target) of ``tests/test_e2e_sequence_ranking.py``."""
    target = (feat.SparseFeature("target_item", vocab_size=N_ITEMS, embed_dim=EMBED, padding_idx=0),)
    history = (feat.SequenceFeature("hist_item", vocab_size=N_ITEMS, embed_dim=EMBED, pooling="concat", shared_with="target_item", padding_idx=0),)
    neg = (feat.SequenceFeature("neg_hist_item", vocab_size=N_ITEMS, embed_dim=EMBED, pooling="concat", shared_with="target_item", padding_idx=0),)
    profile = (feat.SparseFeature("user_cat", vocab_size=10, embed_dim=4), feat.DenseFeature("price"))
    return profile, history, neg, target


def build_seq(ranking, feat, name, dropout=0.0, **kw):
    profile, history, neg, target = seq_schema(feat)
    if name == "DIN":
        return ranking.DIN(features=profile, history_features=history, target_features=target, mlp_params={"dims": (16, 8), "dropout": dropout}, attention_mlp_params={"dims": (8,)}, **kw)
    if name == "BST":
        return ranking.BST(features=profile, history_features=history, target_features=target, mlp_params={"dims": (16,), "dropout": dropout}, nhead=2, num_layers=1, max_seq_len=SEQ_LEN + 1, dim_feedforward=32, dropout=dropout, **kw)
    return ranking.DIEN(features=profile, history_features=history, neg_history_features=neg, target_features=target, mlp_params={"dims": (16,), "dropout": dropout}, alpha=0.2, **kw)


def build(ranking, feat, name, dropout=0.0, **kw):
    return (build_seq if name in SEQ_MODELS else build_ctr)(ranking, feat, name, dropout, **kw)


def seq_frame(n, seed=0, all_pad_rows=2):
    """``tests/test_e2e_sequence_ranking.py::seq_data(with_neg=True)``, with its first rows' histories all PAD."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, SEQ_LEN + 1, n)
    hist = np.zeros((n, SEQ_LEN), dtype=np.int32)
    for i, length in enumerate(lengths):
        hist[i, :length] = rng.integers(1, N_ITEMS, length)
    hist[:all_pad_rows] = 0
    neg = np.where(hist > 0, (hist + rng.integers(1, N_ITEMS - 1, hist.shape)) % N_ITEMS, 0)
    neg = np.where((neg == 0) & (hist > 0), 1, neg)
    x = {"hist_item": hist, "neg_hist_item": neg.astype(np.int32), "target_item": rng.integers(1, N_ITEMS, n).astype(np.int32),
         "user_cat": rng.integers(0, 10, n).astype(np.int32), "price": rng.normal(size=n).astype(np.float32)}
    return x, rng.integers(0, 2, n).astype(np.float32)


def frame(name, n, seed=0):
    return seq_frame(n, seed) if name in SEQ_MODELS else ctr_frame(n, seed)


# ---------------------------------------------------------------------------
# one step against a reference step
# ---------------------------------------------------------------------------

def bn_invariant(names):
    """The Dense biases right in front of a BatchNorm: the batch mean removes them, so the loss does not
    depend on them and their gradient is exactly 0."""
    out = set()
    for name in names:
        m = re.match(r"(.*)Dense_(\d+)\.bias$", name)
        if m and f"{m.group(1)}BatchNorm_{m.group(2)}.weight" in names:
            out.add(name)
    return out


def adam_first_update(g, p0, wd=WD):
    """The first Adam step's update in float64: weight decay in the gradient, m_hat = g, v_hat = g²."""
    g = g.astype(np.float64) + wd * p0.astype(np.float64)
    return g / (np.abs(g) + 1e-8)


def check_step(grads, after, ref_grads, ref_after, before, rows, lr=LR, ref_grad_noise=False):
    """One Adam step against a reference step from the same weights (dicts of numpy arrays by name).

    Each gradient within GRAD_RTOL of the reference's, and GRAD_ATOL_REL of
    the model's largest gradient: a gradient is a sum over the rows that may
    cancel, so its error scales with the terms and not with the sum.  The
    Dense biases in front of a BatchNorm (``bn_invariant``) do not change
    the loss, so their gradients are rounding noise whose size says
    nothing (the BatchNorm divides by the batch's standard deviation,
    which can be tiny): they are not compared, and each side's step is an
    Adam step of a sign of its own, so the two may differ by up to
    ``2 · lr``.  Any other gradient that is exactly 0 (e.g. the last cross
    layer's bias of a stacked DCNv2, a shift in front of the MLP's
    BatchNorm) must be rounding noise below ``rows · eps`` of the largest
    gradient on both sides.  Each parameter after the step within Adam's
    tolerance plus what the update rule makes of the two gradients'
    difference (the first step is about ``lr · sign(g)``).
    ``ref_grad_noise``: the reference step took another gradient than
    ``ref_grads`` within their tolerance (JAX's jitted step against
    ``jax.value_and_grad``), and that is allowed too.
    """
    assert set(grads) == set(ref_grads) == set(after)
    largest = max(float(np.abs(r).max()) for r in ref_grads.values())
    floor = rows * EPS32 * largest
    invariant = bn_invariant(set(ref_grads))
    for name, r in ref_grads.items():
        g, p0 = grads[name], before[name]
        got, ref = after[name], ref_after[name]
        if name in invariant:
            assert np.isfinite(g).all() and (np.abs(got - ref) <= 2 * lr * (1 + 1e-6) + ADAM_RTOL * np.abs(ref)).all(), name
            continue
        if np.abs(r).max() < floor:
            assert np.abs(g).max() < floor, name
            grad_tol = floor
        else:
            grad_tol = GRAD_RTOL * np.abs(r) + GRAD_ATOL_REL * largest
            np.testing.assert_allclose(g, r, rtol=GRAD_RTOL, atol=GRAD_ATOL_REL * largest, err_msg=name)
        u_ref = adam_first_update(r, p0)
        carried = np.abs(adam_first_update(g, p0) - u_ref)
        if ref_grad_noise:
            carried = carried + np.maximum(*(np.abs(adam_first_update(r + s * grad_tol, p0) - u_ref) for s in (-1, 1)))
        bad = np.abs(got - ref) > ADAM_UPDATE_TOL * lr + ADAM_RTOL * np.abs(ref) + lr * carried
        assert not bad.any(), (name, got[bad][:4], ref[bad][:4], g[bad][:4], r[bad][:4])
        assert not np.array_equal(got, p0) or not r.any(), name  # every parameter with a gradient moved


def ratio(got, ref, rtol, atol):
    return float(((got - ref).abs() / (atol + rtol * ref.abs())).max())


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


@torch.no_grad()
def redraw_tables(model, seed):
    """Every embedding table redrawn at N(0, 0.3²), as the CPU parity tests do: with a fresh model's 1e-4
    tables, BST's target position is the same position embedding in every row, and the train-mode
    BatchNorm of its MLP then divides by a variance that E[x²] − E[x]² loses to fp32 rounding."""
    g = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith("_table"):
            p.copy_(0.3 * torch.randn(p.shape, generator=g))
    return model


def pair(name, device, seed=0):
    """The same seeded model on the CPU and on ``device``, its tables redrawn."""
    cpu = redraw_tables(build(tranking, tfeat, name, generator=torch.Generator().manual_seed(seed)), seed)
    dev = redraw_tables(build(tranking, tfeat, name, generator=torch.Generator().manual_seed(seed), device=device), seed)
    for (key, a), b in zip(cpu.state_dict().items(), dev.state_dict().values(), strict=True):
        assert b.device.type == device.type and torch.equal(a, b.cpu()), key
    return cpu, dev


@pytest.mark.cuda
@pytest.mark.parametrize("name", CTR_MODELS + SEQ_MODELS)
def test_zoo_forward_on_the_card_matches_the_cpu(card, name):
    cpu, dev = pair(name, card)
    x, _ = frame(name, BATCH, seed=1)
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    dx = {k: v.to(card) for k, v in tx.items()}
    for mode in ("eval", "train"):
        ref, got = getattr(cpu, mode)()(tx), getattr(dev, mode)()(dx)
        if name == "DIEN":
            assert ratio(got[1].detach().cpu(), ref[1].detach(), LOGIT_RTOL, LOGIT_ATOL) <= 1.0, mode
            ref, got = ref[0], got[0]
        got = got.detach().cpu()
        assert got.shape == (BATCH,) and torch.isfinite(got).all()
        assert ratio(got, ref.detach(), LOGIT_RTOL, LOGIT_ATOL) <= 1.0, mode
    for (key, a), b in zip(cpu.named_buffers(), dev.buffers(), strict=True):
        if a.is_floating_point():  # the train forward's BatchNorm statistics
            assert ratio(b.cpu(), a, STATS_RTOL, STATS_ATOL) <= 1.0, key


@pytest.mark.cuda
@pytest.mark.parametrize("name", CTR_MODELS + SEQ_MODELS)
def test_zoo_train_step_on_the_card_matches_the_cpu(card, name):
    """One CTRTrainer step on a partial batch (padded by cycling rows, weight 0), from the same weights."""
    cpu, dev = pair(name, card, seed=2)
    x, y = frame(name, BATCH - 56, seed=3)
    before = {k: v.detach().numpy().copy() for k, v in cpu.named_parameters()}
    losses = [CTRTrainer(m, optimizer_params={"lr": LR, "weight_decay": WD}, loss_mode=name != "DIEN", device=d).train_one_epoch(ArrayLoader(x, y, batch_size=BATCH), log_interval=0)
              for m, d in ((cpu, "cpu"), (dev, card))]
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses[1], losses[0], rtol=LOSS_RTOL, atol=LOSS_ATOL)
    named = dict(dev.named_parameters())
    check_step({k: p.grad.cpu().numpy() for k, p in named.items()}, {k: p.detach().cpu().numpy() for k, p in named.items()},
               {k: p.grad.numpy() for k, p in cpu.named_parameters()}, {k: p.detach().numpy() for k, p in cpu.named_parameters()}, before, BATCH)
