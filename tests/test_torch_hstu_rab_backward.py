"""Backward of the port's rab attention against the JAX package.

The plain backward (``dense_backward``, autograd of the plain forward) is the
CPU path and the yardstick of the three CUDA backward kernels (K2, K2a, K2b;
checked against it on the card by ``test_torch_cuda_kernels.py``).  Here it
is held against JAX three ways: ``jax.vjp`` of ``_dense_forward``, the fused
Pallas backward K2 and the split pair K2a/K2b, both in interpret mode.  The
fixtures are those of ``test_pallas_hstu_rab.py``, made with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_hstu_rab_attention import ALPHA, DV, MAXL, NB, jcfg, make_inputs
from torch_rechub_tpu.ops.pallas import hstu_rab_attention as jmod
from torch_rechub_tpu_torch.ops.cuda import hstu_rab_attention as tmod

# The JAX package's own kernel-vs-dense gradient tolerances
# (test_pallas_hstu_rab.py:61 and, on the adversarial inputs, :231).
RTOL, ATOL = 3e-4, 3e-5
ADV_RTOL, ADV_ATOL = 5e-4, 5e-5
NAMES = ("dq", "dk", "dv", "dpos", "dts")
CFG = tmod.BucketCfg(NB)


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def jax_route(request):
    """How JAX computes its gradient: its dense vjp, K2 or K2a/K2b (interpret mode)."""
    route = request.param
    jmod._FORCE_INTERPRET[0] = route != "dense_vjp"
    jmod._FUSED_BWD[0] = route != "K2a+K2b"
    yield route
    jmod._FORCE_INTERPRET[0] = False
    jmod._FUSED_BWD[0] = True


ROUTES = ["dense_vjp", "K2", "K2a+K2b"]


def out_grad(arrays, seed):
    return np.random.default_rng(seed).normal(size=arrays[2].shape[:3] + (DV,)).astype(np.float32)


def plain_grads(arrays, g):
    q, k, v, pos_w, ts_w, ts, mask = (None if a is None else torch.from_numpy(a) for a in arrays)
    grads = tmod.dense_backward(q, k, v, torch.from_numpy(g), pos_w, ts_w, ts, mask, ALPHA, MAXL, CFG, ts is not None)
    return [x.numpy() for x in grads]


def jax_grads(arrays, g, route):
    q, k, v, pos_w, ts_w, ts, mask = (None if a is None else jnp.asarray(a) for a in arrays)
    has_time = ts is not None

    def f(q, k, v, pos_w, ts_w):
        if route == "dense_vjp":
            return jmod._dense_forward(q, k, v, pos_w, ts_w, ts, mask, ALPHA, MAXL, jcfg(CFG), has_time)
        return jmod.hstu_attention_rab(q, k, v, pos_w, ts_w, ts, mask, ALPHA, MAXL, jcfg(CFG), 128, 128)

    _, vjp = jax.vjp(f, q, k, v, pos_w, ts_w)
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def assert_grads(got, ref, rtol, atol, what):
    for name, a, b in zip(NAMES, got, ref, strict=True):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("jax_route", ROUTES, indirect=True)
@pytest.mark.parametrize("has_time", [False, True], ids=["no_time", "time"])
def test_plain_backward_matches_jax(jax_route, has_time):
    arrays = make_inputs(seed=1, has_time=has_time)
    g = out_grad(arrays, 2)
    assert_grads(plain_grads(arrays, g), jax_grads(arrays, g, jax_route), RTOL, ATOL, jax_route)


@pytest.mark.parametrize("jax_route", ROUTES, indirect=True)
@pytest.mark.parametrize("case", ["shuffled_ts", "scattered_mask", "empty_row", "wrapping_ts"])
def test_plain_backward_matches_jax_on_adversarial_inputs(jax_route, case):
    arrays = make_inputs(seed=13, case=case)
    g = out_grad(arrays, 14)
    got = plain_grads(arrays, g)
    assert_grads(got, jax_grads(arrays, g, jax_route), ADV_RTOL, ADV_ATOL, f"{case} {jax_route}")
    if case == "empty_row":  # a fully masked row: zero gradients, never NaN
        assert np.all(got[0][0] == 0) and all(np.isfinite(x).all() for x in got)


@pytest.mark.parametrize("jax_route", ["dense_vjp"], indirect=True)
@pytest.mark.parametrize("l,case,has_time", [(200, "suffix_pad", True), (200, "no_mask", False), (77, "scattered_mask", True), (96, "no_mask", True)])
def test_plain_backward_matches_jax_at_ragged_length(jax_route, l, case, has_time):
    # the JAX op takes its dense path here (L % 128 != 0 or no mask): its vjp is the reference
    arrays = make_inputs(seed=3, l=l, case=case, has_time=has_time)
    g = out_grad(arrays, 4)
    assert_grads(plain_grads(arrays, g), jax_grads(arrays, g, jax_route), RTOL, ATOL, f"L{l} {case}")


# ---------------------------------------------------------------------------
# the wrappers on the CPU
# ---------------------------------------------------------------------------

def torch_inputs(seed=5, l=64, case="suffix_pad"):
    arrays = make_inputs(seed=seed, l=l, case=case)
    return [None if a is None else torch.from_numpy(a) for a in arrays], torch.from_numpy(out_grad(arrays, seed + 1))


def test_wrapper_gradient_on_cpu_is_the_plain_one():
    (q, k, v, pos_w, ts_w, ts, mask), g = torch_inputs()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, pos_w, ts_w)]
    counts = (tmod.launches, tmod.launches_bwd, tmod.launches_bwd_dq, tmod.launches_bwd_dkv)
    tmod.hstu_attention_rab(*leaves, ts, mask, ALPHA, MAXL, CFG).backward(g)
    ref = tmod.dense_backward(q, k, v, g, pos_w, ts_w, ts, mask, ALPHA, MAXL, CFG, True)
    for name, leaf, r in zip(NAMES, leaves, ref):
        torch.testing.assert_close(leaf.grad, r, rtol=0, atol=0, msg=name)
    assert (tmod.launches, tmod.launches_bwd, tmod.launches_bwd_dq, tmod.launches_bwd_dkv) == counts


def test_kernel_wrappers_on_cpu_return_their_part_of_the_plain_backward():
    (q, k, v, pos_w, ts_w, ts, mask), g = torch_inputs(case="scattered_mask")
    args = (q, k, v, g, pos_w, ts_w, ts, mask, ALPHA, MAXL, CFG)
    ref = tmod.dense_backward(*args, True)
    counts = (tmod.launches_bwd, tmod.launches_bwd_dq, tmod.launches_bwd_dkv)
    fused = tmod.rab_backward_fused(*args)
    dq, dpos, dts = tmod.rab_backward_dq(*args)
    dk, dv = tmod.rab_backward_dkv(*args)
    assert (tmod.launches_bwd, tmod.launches_bwd_dq, tmod.launches_bwd_dkv) == counts
    for name, a, b, c in zip(NAMES, fused, (dq, dk, dv, dpos, dts), ref):
        torch.testing.assert_close(a, c, rtol=0, atol=0, msg=name)
        torch.testing.assert_close(b, c, rtol=0, atol=0, msg=name)
    with pytest.raises(ValueError, match="CUDA"):
        tmod.rab_backward_dkv(*(t.to("meta") if isinstance(t, torch.Tensor) else t for t in args))


@pytest.mark.parametrize("fused", [True, False], ids=["K2", "K2a+K2b"])
def test_autograd_function_plumbing(monkeypatch, fused):
    """The kernel path's autograd Function on CPU tensors, with K1's launch
    replaced by the plain forward: it saves what the backward needs, hands
    the backward a contiguous gradient, calls K2 or K2a then K2b by
    ``_FUSED_BWD`` and returns the gradients in the inputs' order."""
    (q, k, v, pos_w, ts_w, ts, mask), g = torch_inputs(seed=7, case="shuffled_ts")
    monkeypatch.setattr(tmod, "_launch", lambda q, k, v, pos_w, ts_w, ts, mask, thr, alpha, maxl, cfg: tmod.dense_forward(q, k, v, pos_w, ts_w, ts, mask, alpha, maxl, cfg, ts is not None))
    calls = []
    for name in ("rab_backward_fused", "rab_backward_dq", "rab_backward_dkv"):
        orig = getattr(tmod, name)

        def spy(q, k, v, g, *rest, _orig=orig, _name=name):
            assert g.is_contiguous()
            calls.append(_name)
            return _orig(q, k, v, g, *rest)

        monkeypatch.setattr(tmod, name, spy)
    monkeypatch.setitem(tmod.__dict__, "_FUSED_BWD", [fused])
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, pos_w, ts_w)]
    thr = tmod.compute_bucket_thresholds(CFG)
    out = tmod._RabAttentionKernel.apply(*leaves, ts, mask, thr, ALPHA, MAXL, CFG)
    out.transpose(1, 2).contiguous().transpose(1, 2).backward(g)  # a non-contiguous gradient
    assert calls == (["rab_backward_fused"] if fused else ["rab_backward_dq", "rab_backward_dkv"])
    ref = tmod.dense_backward(q, k, v, g, pos_w, ts_w, ts, mask, ALPHA, MAXL, CFG, True)
    for name, leaf, r in zip(NAMES, leaves, ref):
        torch.testing.assert_close(leaf.grad, r, rtol=0, atol=0, msg=name)
