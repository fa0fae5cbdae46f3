"""Port of the rab attention op (``torch_rechub_tpu_torch/ops/cuda/hstu_rab_attention.py``)
against the JAX package: bucket thresholds, the plain PyTorch version against
JAX's dense reference and its Pallas kernel (interpret mode), and the
wrapper's dispatch rules.  The CUDA kernel itself is checked on the card by
``test_torch_cuda_kernels.py``.

Inputs are made with numpy from a seed and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_rechub_tpu.ops.pallas import hstu_rab_attention as jmod
from torch_rechub_tpu_torch.ops.cuda import hstu_rab_attention as tmod

B, H, L, DQK, DV = 2, 3, 256, 32, 32
MAXL = 256
NB = 16
ALPHA = 0.125
# Forward tolerance of the JAX package's own kernel-vs-dense test
# (test_pallas_hstu_rab.py:41): f32 sums of up to L terms taken in another order.
RTOL = ATOL = 2e-5


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def force_interpret():
    jmod._FORCE_INTERPRET[0] = True
    yield
    jmod._FORCE_INTERPRET[0] = False


def jcfg(cfg):
    return jmod.BucketCfg(*cfg)


def make_inputs(seed=0, l=L, case="suffix_pad", has_time=True):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, H, l, DQK)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(B, H, l, DQK)) * 0.3).astype(np.float32)
    v = (rng.normal(size=(B, H, l, DV)) * 0.3).astype(np.float32)
    pos_w = (rng.normal(size=(2 * MAXL - 1, H)) * 0.1).astype(np.float32)
    ts_w = (rng.normal(size=(NB + 1, H)) * 0.1).astype(np.float32)
    if case == "suffix_pad":
        ts = np.sort(rng.integers(0, 3_000_000, (B, l)), axis=1).astype(np.int32)
        mask = np.concatenate([np.ones((B, l - 17)), np.zeros((B, 17))], axis=1).astype(bool)
    else:  # the adversarial cases of test_pallas_hstu_rab.py:197
        ts = rng.integers(0, 3_000_000, (B, l)).astype(np.int32)  # not sorted
        if case == "wrapping_ts":
            # stamps at both ends of int32: their int32 differences wrap to small values
            near = rng.integers(0, 20_000, (B, l))
            ts = np.where(rng.uniform(size=(B, l)) < 0.5, 2**31 - 1 - near, -(2**31) + near).astype(np.int32)
            mask = np.ones((B, l), bool)
        elif case == "shuffled_ts":
            mask = np.ones((B, l), bool)
        elif case == "scattered_mask":
            mask = rng.uniform(size=(B, l)) > 0.3
        elif case == "empty_row":
            mask = np.ones((B, l), bool)
            mask[0, :] = False
        elif case == "no_mask":
            mask = None
        else:
            raise ValueError(case)
    return q, k, v, pos_w, ts_w, (ts if has_time else None), mask


def run_plain(arrays, cfg=tmod.BucketCfg(NB)):
    q, k, v, pos_w, ts_w, ts, mask = (None if a is None else torch.from_numpy(a) for a in arrays)
    return tmod.dense_forward(q, k, v, pos_w, ts_w, ts, mask, ALPHA, MAXL, cfg, ts is not None).numpy()


def run_jax_dense(arrays, cfg=tmod.BucketCfg(NB)):
    q, k, v, pos_w, ts_w, ts, mask = (None if a is None else jnp.asarray(a) for a in arrays)
    return np.asarray(jmod._dense_forward(q, k, v, pos_w, ts_w, ts, mask, ALPHA, MAXL, jcfg(cfg), ts is not None))


def run_jax_kernel(arrays, cfg=tmod.BucketCfg(NB)):
    q, k, v, pos_w, ts_w, ts, mask = (None if a is None else jnp.asarray(a) for a in arrays)
    return np.asarray(jmod.hstu_attention_rab(q, k, v, pos_w, ts_w, ts, mask, ALPHA, MAXL, jcfg(cfg), 128, 128))


# ---------------------------------------------------------------------------
# (a) bucket thresholds
# ---------------------------------------------------------------------------

SQRT_CFGS = [(16, "sqrt", 1.0, "minutes"), (128, "sqrt", 1.0, "minutes"), (64, "sqrt", 2.0, "seconds")]
LOG_CFGS = [(32, "log", 0.5, "seconds"), (128, "log", 1.0, "minutes")]


@pytest.mark.parametrize("cfg", SQRT_CFGS, ids=str)
def test_thresholds_equal_jax_exactly_for_sqrt(cfg):
    # sqrt and division are correctly rounded in both packages: the edges are identical
    got = tmod.compute_bucket_thresholds(tmod.BucketCfg(*cfg)).numpy()
    ref = np.asarray(jmod.compute_bucket_thresholds(jcfg(cfg)))
    assert got.dtype == np.int32 and got.shape == (cfg[0] + 1,)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("cfg", SQRT_CFGS + LOG_CFGS, ids=str)
def test_thresholds_reproduce_bucketize_edges(cfg):
    """(|dt| >= thr[u]) <=> (bucketize(dt) >= u) at random dts and at every
    edge's +-1 neighbourhood: exactly for sqrt; for log only ints in the
    wobble band below an edge may disagree, as in test_pallas_hstu_rab.py:184-194."""
    c = tmod.BucketCfg(*cfg)
    imax = np.iinfo(np.int32).max
    thr = tmod.compute_bucket_thresholds(c).numpy().astype(np.int64)
    us = np.arange(c.num_buckets + 1)
    assert thr[0] == 0 and np.all(np.diff(thr) >= 0)
    reach = thr < imax
    at = tmod._bucketize(torch.from_numpy(thr[reach]), c).numpy()
    assert np.all(at >= us[reach])
    edges = thr[reach]
    rng = np.random.default_rng(5)
    dts = np.unique(np.concatenate([rng.integers(0, imax, 4096), edges, np.maximum(edges - 1, 0), np.minimum(edges + 1, imax - 1)]))
    b = tmod._bucketize(torch.from_numpy(dts), c).numpy()
    ge_thr = dts[:, None] >= thr[None, :]
    ge_bucket = b[:, None] >= us[None, :]
    if c.fn == "sqrt":
        prev_ok = reach & (thr > 0)
        below = tmod._bucketize(torch.from_numpy(thr[prev_ok] - 1), c).numpy()
        assert np.all(below < us[prev_ok])
        np.testing.assert_array_equal(ge_thr, ge_bucket)
    else:
        rows, cols = np.nonzero(ge_thr != ge_bucket)
        if rows.size:
            assert np.all(np.abs(dts[rows] - thr[cols]) < 64)
            assert rows.size < dts.size
        # the JAX package's log edges agree within the same band
        ref = np.asarray(jmod.compute_bucket_thresholds(jcfg(cfg))).astype(np.int64)
        assert np.all((ref == thr) | (np.abs(ref - thr) < 64))


@pytest.mark.parametrize("cfg", SQRT_CFGS + LOG_CFGS, ids=str)
def test_bucketize_time_matches_jax(cfg):
    from torch_rechub_tpu.utils.hstu_utils import bucketize_time as jbucketize
    from torch_rechub_tpu_torch.utils.hstu_utils import bucketize_time

    rng = np.random.default_rng(7)
    dt = rng.integers(-(10**9), 10**9, 20000).astype(np.int32)
    nb, fn, div, unit = cfg
    got = bucketize_time(torch.from_numpy(dt), nb, fn, div, unit).numpy()
    ref = np.asarray(jbucketize(jnp.asarray(dt), nb, fn, div, unit))
    if fn == "sqrt":
        np.testing.assert_array_equal(got, ref)
    else:  # log may round one ulp apart between the packages: off by one bucket at most, rarely
        assert np.abs(got - ref).max() <= 1 and np.mean(got != ref) < 1e-3


# ---------------------------------------------------------------------------
# (b) plain version == JAX dense reference == JAX kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("has_time", [False, True])
def test_plain_matches_jax_dense_and_kernel(force_interpret, has_time):
    arrays = make_inputs(seed=0, has_time=has_time)
    got = run_plain(arrays)
    np.testing.assert_allclose(got, run_jax_dense(arrays), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, run_jax_kernel(arrays), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["shuffled_ts", "scattered_mask", "empty_row", "wrapping_ts"])
def test_plain_matches_jax_on_adversarial_inputs(force_interpret, case):
    arrays = make_inputs(seed=13, case=case)
    got = run_plain(arrays)
    np.testing.assert_allclose(got, run_jax_dense(arrays), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, run_jax_kernel(arrays), rtol=RTOL, atol=ATOL)
    if case == "empty_row":
        assert np.all(got[0] == 0) and np.isfinite(got).all()


@pytest.mark.parametrize("l,case,has_time", [(200, "suffix_pad", True), (200, "no_mask", False), (77, "scattered_mask", True)])
def test_plain_matches_jax_at_ragged_length(l, case, has_time):
    # the JAX op takes its dense path here (L % 128 != 0 or no mask): that is the reference
    arrays = make_inputs(seed=3, l=l, case=case, has_time=has_time)
    np.testing.assert_allclose(run_plain(arrays), run_jax_dense(arrays), rtol=RTOL, atol=ATOL)


def test_plain_log_buckets_match_jax():
    cfg = tmod.BucketCfg(NB, "log", 0.5, "seconds")
    arrays = make_inputs(seed=4)
    np.testing.assert_allclose(run_plain(arrays, cfg), run_jax_dense(arrays, cfg), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# dispatch rules of the wrapper
# ---------------------------------------------------------------------------

def test_wrapper_on_cpu_is_the_plain_version():
    arrays = make_inputs(seed=5)
    q, k, v, pos_w, ts_w, ts, mask = (torch.from_numpy(a) for a in arrays)
    before = tmod.launches
    out = tmod.hstu_attention_rab(q, k, v, pos_w, ts_w, ts, mask, ALPHA, MAXL, tmod.BucketCfg(NB))
    assert tmod.launches == before
    np.testing.assert_array_equal(out.numpy(), run_plain(arrays))


def test_wrapper_on_cpu_is_differentiable():
    arrays = make_inputs(seed=6, l=64)
    q, k, v, pos_w, ts_w, ts, mask = (torch.from_numpy(a) for a in arrays)
    q.requires_grad_(True)
    pos_w.requires_grad_(True)
    tmod.hstu_attention_rab(q, k, v, pos_w, ts_w, ts, mask, ALPHA, MAXL, tmod.BucketCfg(NB)).sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all() and pos_w.grad.abs().sum() > 0


def test_wrapper_rejects_other_devices_and_long_sequences():
    q = torch.empty((1, H, 8, DQK), device="meta")
    v = torch.empty((1, H, 8, DV), device="meta")
    pos_w = torch.empty((2 * MAXL - 1, H), device="meta")
    ts_w = torch.empty((NB + 1, H), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tmod.hstu_attention_rab(q, q, v, pos_w, ts_w, None, None, ALPHA, MAXL, tmod.BucketCfg(NB))
    long_q = torch.zeros((1, H, MAXL + 1, DQK))
    with pytest.raises(ValueError, match="max_seq_len"):
        tmod.hstu_attention_rab(long_q, long_q, long_q, pos_w, ts_w, None, None, ALPHA, MAXL, tmod.BucketCfg(NB))
