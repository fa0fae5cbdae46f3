"""The rab kernels' O(1) bucket lookup (``bucket_lookup``, the plain version
of what K1 and K2 compute on the card) against ``bucketize_time`` of both
packages, and the plumbing that hands the bucket config to the kernels.

The lookup guesses a bucket with the f32 steps of ``bucketize_time`` and
moves it to the largest ``u`` with ``thr[u] <= |dt|``.  It has to agree
with ``bucketize_time`` at every threshold, one below and one above, and at
the wrapped int32 differences, ``|dt| = 2**31`` included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_rechub_tpu.utils.hstu_utils import bucketize_time as jbucketize
from torch_rechub_tpu_torch.ops.cuda import hstu_rab_attention as tmod
from torch_rechub_tpu_torch.utils.hstu_utils import bucketize_time

CFGS = [tuple(c) for c in tmod.SWEEP_CFGS] + [(16, "sqrt", 1.0, "minutes"), (32, "log", 0.5, "seconds")]
IMAX = 2**31 - 1


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def edge_differences(thr):
    """Every reachable threshold -1, 0 and +1, of both signs, and the int32 extremes."""
    e = thr.to(torch.int64)
    e = e[e < IMAX]
    near = torch.cat([e - 1, e, e + 1]).clamp(0, IMAX)
    return torch.cat([near, -near, torch.tensor([IMAX, -IMAX, -(2**31)])]).to(torch.int32)


def wrapped_differences(seed=0, n=20000):
    """int32 differences of random stamps, wrapping as the kernels' int32 subtraction does."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-(2**31), 2**31, n, dtype=np.int64)
    b = rng.integers(-(2**31), 2**31, n, dtype=np.int64)
    wrapped = ((a - b + 2**31) % 2**32 - 2**31).astype(np.int32)
    small = rng.integers(-(10**7), 10**7, n).astype(np.int32)
    return torch.from_numpy(np.concatenate([wrapped, small, np.array([-(2**31), IMAX, 0], np.int32)]))


def threshold_bucket(dt, thr):
    """The largest u with thr[u] <= |dt| (|dt| clamped below the int32-max sentinel), by counting."""
    a = dt.to(torch.int64).abs().clamp_max(IMAX - 1)
    return (thr.to(torch.int64)[None, :] <= a[:, None]).sum(1) - 1


@pytest.mark.parametrize("cfg", CFGS, ids=str)
def test_lookup_matches_bucketize_at_every_threshold(cfg):
    c = tmod.BucketCfg(*cfg)
    thr = tmod.compute_bucket_thresholds(c)
    dt = edge_differences(thr)
    got = tmod.bucket_lookup(dt, thr, c)
    np.testing.assert_array_equal(got.numpy(), bucketize_time(dt, *cfg).numpy())
    np.testing.assert_array_equal(got.numpy(), threshold_bucket(dt, thr).numpy())
    assert int(tmod.bucket_lookup(torch.tensor([-(2**31)], dtype=torch.int32), thr, c)) == int(bucketize_time(torch.tensor([IMAX], dtype=torch.int32), *cfg))


@pytest.mark.parametrize("cfg", CFGS, ids=str)
def test_lookup_matches_bucketize_on_wrapped_differences(cfg):
    c = tmod.BucketCfg(*cfg)
    thr = tmod.compute_bucket_thresholds(c)
    dt = wrapped_differences()
    got = tmod.bucket_lookup(dt, thr, c)
    np.testing.assert_array_equal(got.numpy(), bucketize_time(dt, *cfg).numpy())
    np.testing.assert_array_equal(got.numpy(), threshold_bucket(dt, thr).numpy())


@pytest.mark.parametrize("cfg", CFGS, ids=str)
def test_lookup_matches_jax_bucketize(cfg):
    c = tmod.BucketCfg(*cfg)
    thr = tmod.compute_bucket_thresholds(c)
    dt = torch.cat([edge_differences(thr), wrapped_differences(seed=1, n=4000)])
    got = tmod.bucket_lookup(dt, thr, c).numpy()
    ref = np.asarray(jbucketize(jnp.asarray(dt.numpy()), *cfg))
    if c.fn == "sqrt":
        np.testing.assert_array_equal(got, ref)
    else:  # log may round one ulp apart between the packages: off by one bucket at most, rarely
        assert np.abs(got - ref).max() <= 1 and np.mean(got != ref) < 1e-2


@pytest.mark.parametrize("cfg", tmod.SWEEP_CFGS, ids=lambda c: str(tuple(c)))
def test_sweep_stamps_hit_every_threshold_and_the_wrap(cfg):
    """The card's bucket sweep (``bucket_sweep_stamps``) reaches every edge it claims to."""
    thr = tmod.compute_bucket_thresholds(cfg).to(torch.int64)
    ts = tmod.bucket_sweep_stamps(cfg)
    assert ts.dtype == torch.int32 and ts.shape[0] == 2 and ts[0, 0] == 0
    ts = ts.to(torch.int64)
    edges = thr[thr < IMAX]
    want = set(torch.cat([edges - 1, edges, edges + 1]).clamp(0, IMAX).tolist())
    assert set(ts[0, 1:].abs().tolist()) == want
    wrapped = (ts[1][:, None] - ts[1][None, :] + 2**31) % 2**32 - 2**31
    assert bool((wrapped == -(2**31)).any())


def test_lookup_guess_is_moved_both_ways():
    """A guess off by several buckets either way still lands on the exact bucket."""
    c = tmod.BucketCfg(128, "sqrt", 1.0, "minutes")
    thr = tmod.compute_bucket_thresholds(c)
    dt = edge_differences(thr)
    for wrong in (tmod.BucketCfg(128, "sqrt", 4.0, "minutes"), tmod.BucketCfg(128, "sqrt", 0.25, "minutes")):
        np.testing.assert_array_equal(tmod.bucket_lookup(dt, thr, wrong).numpy(), tmod.bucket_lookup(dt, thr, c).numpy())


# ---------------------------------------------------------------------------
# the bucket config reaches the kernels
# ---------------------------------------------------------------------------

class FakeLib:
    """Stands in for the ctypes library: records each entry's arguments, returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


class FakeStream:
    cuda_stream = 1234


@pytest.fixture
def fake_card(monkeypatch):
    """The launch path on CPU tensors: no card, the library and stream faked."""
    lib = FakeLib()
    monkeypatch.setattr(tmod, "_lib", lambda: lib)
    monkeypatch.setattr(tmod, "_lib_bwd", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: FakeStream())
    return lib


def small_inputs(l=24, h=2, d=8, nb=16, maxl=32):
    rng = np.random.default_rng(3)
    t = lambda *s: torch.from_numpy((rng.normal(size=s) * 0.3).astype(np.float32))  # noqa: E731
    ts = torch.from_numpy(np.sort(rng.integers(0, 10**6, (2, l)), axis=1).astype(np.int32))
    return t(2, h, l, d), t(2, h, l, d), t(2, h, l, d), t(2 * maxl - 1, h), t(nb + 1, h), ts, torch.ones((2, l), dtype=torch.bool), maxl


@pytest.mark.parametrize("cfg", [(16, "sqrt", 1.0, "minutes"), (16, "log", 2.0, "seconds")], ids=str)
def test_launches_pass_the_bucket_config(fake_card, cfg):
    c = tmod.BucketCfg(*cfg)
    q, k, v, pos_w, ts_w, ts, mask, maxl = small_inputs()
    thr = tmod.compute_bucket_thresholds(c)
    tmod._launch(q, k, v, pos_w, ts_w, ts, mask, thr, 0.5, maxl, c)
    for entry in ("hstu_rab_bwd", "hstu_rab_bwd_dq", "hstu_rab_bwd_dkv"):
        tmod._launch_bwd(entry, q, k, v, torch.zeros_like(v), pos_w, ts_w, ts, mask, thr, 0.5, maxl, c, dq=torch.zeros_like(q))
    names = [name for name, _ in fake_card.calls]
    assert names == ["hstu_rab_fwd", "hstu_rab_bwd", "hstu_rab_bwd_dq", "hstu_rab_bwd_dkv"]
    for _, args in fake_card.calls:
        # ... num_buckets, alpha, fn_log, minutes, divisor, stream
        assert args[-6:] == (c.num_buckets, 0.5, int(c.fn == "log"), int(c.unit == "minutes"), c.divisor, FakeStream.cuda_stream)


def test_function_hands_the_config_to_the_forward_launch(monkeypatch):
    """``_RabAttentionKernel`` hands the bucket config through the registered op ``rechub::hstu_rab_fwd``, which
    takes it as four scalars, to the op's body ``_forward`` (which launches K1 on the card) whole."""
    c = tmod.BucketCfg(16, "log", 2.0, "seconds")
    q, k, v, pos_w, ts_w, ts, mask, maxl = small_inputs()
    seen = []

    def fake_launch(q, k, v, pos_w, ts_w, ts, mask, thr, alpha, max_seq_len, cfg):
        seen.append(cfg)
        return tmod.dense_forward(q, k, v, pos_w, ts_w, ts, mask, alpha, max_seq_len, cfg, ts is not None)

    monkeypatch.setattr(tmod, "_forward", fake_launch)
    out = tmod._RabAttentionKernel.apply(q, k, v, pos_w, ts_w, ts, mask, tmod.compute_bucket_thresholds(c), 0.5, maxl, c)
    assert seen == [c]
    torch.testing.assert_close(out, tmod.dense_forward(q, k, v, pos_w, ts_w, ts, mask, 0.5, maxl, c, True), rtol=0, atol=0)


def test_occupancy_asks_for_every_rab_kernel(fake_card):
    """``occupancy`` queries K1, then K2, K2a and K2b by their index in the C interface."""
    occ = tmod.occupancy(256, 32, 24, 256, 128)
    assert list(occ) == ["hstu_rab_fwd", "hstu_rab_bwd", "hstu_rab_bwd_dq", "hstu_rab_bwd_dkv"]
    assert [name for name, _ in fake_card.calls] == ["hstu_rab_fwd_occupancy"] + ["hstu_rab_bwd_occupancy"] * 3
    assert fake_card.calls[0][1][:5] == (256, 32, 24, 256, 128)
    assert [args[:6] for _, args in fake_card.calls[1:]] == [(which, 256, 32, 24, 256, 128) for which in range(3)]
