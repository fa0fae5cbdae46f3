"""The port's sparse row-wise embedding updates on the card, against the port on the CPU.

These tests need a CUDA device and skip without one.  They import torch and
numpy only, so they also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_sparse.py

The CPU side is the port itself, which ``tests/test_torch_sparse_*.py`` hold
against the JAX package.  The updates must not synchronise with the host:
they run here under ``torch.cuda.set_sync_debug_mode("error")``.
"""

import numpy as np
import pytest
import torch

from torch_rechub_tpu_torch.basic.features import DenseFeature, SparseFeature
from torch_rechub_tpu_torch.models.generative.hstu import HSTUModel
from torch_rechub_tpu_torch.models.ranking import DeepFM
from torch_rechub_tpu_torch.ops import embedding as temb
from torch_rechub_tpu_torch.ops import sparse_update as tsu
from torch_rechub_tpu_torch.trainers import CTRTrainer, SeqTrainer
from torch_rechub_tpu_torch.trainers.sparse import apply_sparse_table_updates
from torch_rechub_tpu_torch.utils.data import ArrayLoader, pad_batch

pytestmark = pytest.mark.cuda

ROWS, DIM, N_IDS = 260_032, 16, 24_576  # the fused small config; a batch of 4096 x 6 fused ids
# tables and accumulators: the JAX package's sparse tolerances.  The card's index_add_ sums a row's
# duplicates with float atomics, in another order than the CPU; a sum of n fp32 terms in any order is
# within (n - 1) u sum|terms| of the exact one (u = 2^-24), so an SGD row is also allowed twice that
TABLE_RTOL, TABLE_ATOL = 1e-5, 1e-6
FP32_U = 2.0**-24
FP32_EPS = 2.0**-23
# one CTR step: the loss and the gradients as tests/test_torch_cuda_ctr.py.  An SGD step of a table is
# -lr times its gradient, held to the gradient's tolerances; a row-wise Adagrad step and an accumulator
# (a mean of squared row gradients) to twice the gradient's relative error
LOSS_RTOL, LOSS_ATOL = 2e-5, 1e-5
CTR_GRAD_RTOL, CTR_GRAD_ATOL_REL = 2e-4, 1e-4
ACCUM_RTOL, ACCUM_ATOL_REL = 2 * CTR_GRAD_RTOL, 1e-6
# row gradients through K1 and K2 against the dense table gradients (chip_smoke.py's GRAD_* tolerances)
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-4
MODEL_KW = dict(vocab_size=500, d_model=64, n_heads=2, n_layers=2, dqk=32, dv=32, max_seq_len=64, dropout=0.0, num_time_buckets=16, tie_embeddings=False)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def fused():
    old = temb.set_fused_default(True)
    yield
    temb.set_fused_default(old)


def ratio(got, ref, rtol, atol):
    got, ref = got.detach().cpu().double(), ref.detach().cpu().double()
    return float(((got - ref).abs() / (atol + rtol * ref.abs())).max())


def step_ratio(after, before, d_ref, rtol, atol_rel, adds=1):
    """Worst ``|d - d_ref| / tol`` of a table's step ``d = after - before`` against a reference step.

    The step is held, not the table: one SGD step moves a row by lr times a gradient of a batch
    mean, which can lie below any fixed atol on the table, so an unmoved table would pass that.
    ``tol = rtol |d_ref| + atol_rel max|d_ref| + adds eps (|after| + |before + d_ref|)``, the last
    term the fp32 rounding of the two stored tables: each add into a row rounds once, and ``adds``
    is the most adds one row takes in the step (SGD adds once per occurrence of an id).  Fails
    unless the largest reference step is ten times the largest rounding term, so that a step left
    undone, or taken with another sign or learning rate, cannot pass.
    """
    after, before, d_ref = (t.detach().cpu().double() for t in (after, before, d_ref))
    rounding = adds * FP32_EPS * (after.abs() + (before + d_ref).abs())
    scale = float(d_ref.abs().max())
    assert scale > 10 * float(rounding.max()), f"the reference step (largest {scale:.3e}) is lost in the tables' rounding"
    return float(((after - before - d_ref).abs() / (rtol * d_ref.abs() + atol_rel * scale + rounding)).max())


def sgd_order_bound(table, ids, grads, lr, weight_decay):
    """Per element: lr * 2 (n - 1) u * sum|terms| over a row's n terms (its gradients, and its decay once per
    occurrence), how far the card's and the CPU's fp32 sums of one row can each be from the exact sum."""
    rows = torch.where(ids < 0, ids + table.shape[0], ids)
    n = torch.zeros(table.shape[0], dtype=torch.float64).index_add_(0, rows, torch.ones(rows.shape[0], dtype=torch.float64))
    terms = torch.zeros(table.shape, dtype=torch.float64).index_add_(0, rows, grads.abs().double()) + n[:, None] * weight_decay * table.abs().double()
    return lr * 2 * (2 * n - 1).clamp_min(0)[:, None] * FP32_U * terms


def update_inputs(seed):
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(size=(ROWS, DIM)).astype(np.float32))
    ids = (rng.zipf(1.2, N_IDS) % ROWS).astype(np.int64)
    ids[:4] = [-1, -2, ROWS - 1, 0]  # negative ids; the spare fill row
    grads = torch.from_numpy(rng.normal(size=(N_IDS, DIM)).astype(np.float32))
    return table, torch.from_numpy(ids), grads, torch.from_numpy(rng.uniform(0, 1, ROWS).astype(np.float32))


@pytest.mark.parametrize("method", ["sgd", "adagrad"])
def test_updates_run_without_a_host_sync_and_match_the_cpu(card, method):
    table, ids, grads, accum = update_inputs(1)
    dev = [a.to(card) for a in (table, ids, grads, accum)]
    records = [("t", dev[1][: N_IDS // 2], dev[2][: N_IDS // 2].clone().requires_grad_()), ("t", dev[1][N_IDS // 2:], dev[2][N_IDS // 2:].clone().requires_grad_())]
    for _, _, rows in records:
        rows.grad = rows.detach().clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        if method == "sgd":
            tsu.sparse_sgd_update(dev[0], dev[1], dev[2], 0.05, weight_decay=0.01)
        else:
            tsu.rowwise_adagrad_update(dev[0], dev[3], dev[1], dev[2], 0.05, weight_decay=0.01)
        tables, accums = {"t": dev[0].clone()}, {"t": dev[3].clone()}
        apply_sparse_table_updates(tables, accums, records, method, 0.05)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if method == "sgd":
        ref = tsu.sparse_sgd_update(table.clone(), ids, grads, 0.05, weight_decay=0.01).double()
        tol = TABLE_ATOL + TABLE_RTOL * ref.abs() + sgd_order_bound(table, ids, grads, 0.05, 0.01)
        assert bool(((dev[0].cpu().double() - ref).abs() <= tol).all())
    else:
        ref_t, ref_a = tsu.rowwise_adagrad_update(table.clone(), accum.clone(), ids, grads, 0.05, weight_decay=0.01)
        assert ratio(dev[0], ref_t, TABLE_RTOL, TABLE_ATOL) <= 1.0
        assert ratio(dev[3], ref_a, TABLE_RTOL, TABLE_ATOL) <= 1.0
    u, inv = tsu.unique_with_fill(ids.to(card), ROWS - 1)
    ref_u, ref_inv = tsu.unique_with_fill(ids, ROWS - 1)
    assert torch.equal(u.cpu(), ref_u) and torch.equal(inv.cpu(), ref_inv)


def ctr_models(card, seed):
    sparse = tuple(SparseFeature(f"C{i}", 1000, DIM) for i in range(8))
    dense = tuple(DenseFeature(f"I{i}") for i in range(4))
    mlp = {"dims": (64, 32), "dropout": 0.0, "activation": "relu"}
    cpu = DeepFM(dense, sparse, mlp, generator=torch.Generator().manual_seed(seed))
    dev = DeepFM(dense, sparse, mlp, generator=torch.Generator().manual_seed(seed), device=card)
    return cpu, dev


@pytest.mark.usefixtures("fused")
@pytest.mark.parametrize("method", ["sgd", "adagrad"])
def test_sparse_ctr_step_on_the_card_matches_the_cpu(card, method):
    """One sparse step on a partial batch from the same weights: the loss, the fused table and its
    step, its accumulators; the fused table takes no gradient on the card either."""
    cpu, dev = ctr_models(card, seed=2)
    rng = np.random.default_rng(3)
    x = {f"C{i}": rng.integers(0, 1000, 400).astype(np.int32) for i in range(8)}
    x.update({f"I{i}": rng.normal(size=400).astype(np.float32) for i in range(4)})
    y = rng.integers(0, 2, 400).astype(np.float32)
    trainers = [CTRTrainer(m, sparse_embedding=method, device=d) for m, d in ((cpu, "cpu"), (dev, card))]
    (name,) = trainers[0].sparse_tables
    t0 = trainers[0].sparse_tables[name].detach().clone()
    losses = [tr.train_one_epoch(ArrayLoader(x, y, batch_size=512), log_interval=0) for tr in trainers]
    np.testing.assert_allclose(losses[1], losses[0], rtol=LOSS_RTOL, atol=LOSS_ATOL)
    t_cpu, t_dev = trainers[0].sparse_tables[name], trainers[1].sparse_tables[name]
    assert t_dev.is_cuda and t_dev.grad is None
    assert ratio(t_dev, t_cpu, TABLE_RTOL, TABLE_ATOL) <= 1.0
    # each feature owns its rows of the fused table: an SGD step adds into a row once per occurrence of its id
    xp, _, _ = pad_batch(x, y, 512)
    rtol, adds = (CTR_GRAD_RTOL, max(int(np.bincount(xp[f"C{i}"]).max()) for i in range(8))) if method == "sgd" else (2 * CTR_GRAD_RTOL, 1)
    assert step_ratio(t_dev, t0, t_cpu.detach().double() - t0.double(), rtol, CTR_GRAD_ATOL_REL, adds) <= 1.0
    a_cpu, a_dev = trainers[0].sparse_accums[name], trainers[1].sparse_accums[name]
    assert ratio(a_dev, a_cpu, ACCUM_RTOL, ACCUM_ATOL_REL * float(a_cpu.max()) + 1e-30) <= 1.0


def test_hstu_row_gradients_through_the_kernels_equal_the_dense_ones(card):
    """The untied HSTU on the card (K1 forward, K2 backward), sampled softmax: the recorded rows'
    gradients of both tables, scattered, equal the dense gradients from the same weights and an
    equally seeded generator; a sparse step keeps the PAD row at 0."""
    rng = np.random.default_rng(4)
    toks = rng.integers(1, 500, (4, 64)).astype(np.int64)
    toks[:2, :10] = 0  # a PAD prefix
    tds = np.sort(rng.integers(0, 10**6, (4, 64)), axis=1).astype(np.int32)
    tgts = rng.integers(1, 500, 4).astype(np.int64)
    batch = [torch.from_numpy(a).to(card) for a in (toks, tds, tgts)]
    sparse_model = HSTUModel(**MODEL_KW, generator=torch.Generator().manual_seed(5), device=card)
    dense_model = HSTUModel(**MODEL_KW, device=card)
    dense_model.load_state_dict(sparse_model.state_dict())
    kw = dict(loss_type="sampled_softmax", loss_params={"num_negatives": 64})
    sparse, dense = SeqTrainer(sparse_model, sparse_embedding="sgd", **kw), SeqTrainer(dense_model, **kw)
    for tr in (sparse, dense):
        tr.model.train()
        tr.generator.manual_seed(6)
    with tsu.record_rows(sparse.sparse_tables) as rec:
        sparse.loss_fn(*batch).backward()
    dense.loss_fn(*batch).backward()
    scattered = {n: torch.zeros_like(t) for n, t in sparse.sparse_tables.items()}
    for name, ids, grads in tsu.pair_sparse_grads(rec.records):
        scattered[name].index_add_(0, ids, grads)
    for name, got in scattered.items():
        ref = getattr(dense_model, name).grad
        assert sparse.sparse_tables[name].grad is None
        assert ratio(got, ref, GRAD_RTOL, GRAD_ATOL_REL * float(ref.abs().max()) + 1e-12) <= 1.0, name
    assert not scattered["token_embedding"][0].any()
    sparse.train_step(*batch)
    assert not sparse_model.token_embedding[0].any()
