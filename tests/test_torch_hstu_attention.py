"""Port of the materialised-bias op (``torch_rechub_tpu_torch/ops/cuda/hstu_attention.py``)
against the JAX package: the plain PyTorch version against JAX's op, its
``_xla_reference`` and its Pallas kernel body (interpret mode), the
gradients against JAX's custom VJP, the autograd Function's wiring, and the
op on a materialised rab against the on-the-fly-rab op.  The CUDA kernel
itself is checked on the card by ``test_torch_cuda_kernels.py``.

Inputs are made with numpy from a seed and handed to both packages.

Both packages' ``ops`` packages bind the name ``hstu_attention`` to the op,
so the modules are taken by their full names with ``importlib``.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from torch_rechub_tpu.ops.pallas import hstu_rab_attention as jrab
from torch_rechub_tpu_torch.ops.cuda import hstu_attention as port_op
from torch_rechub_tpu_torch.ops.cuda import hstu_rab_attention as trab
from torch_rechub_tpu_torch.utils.hstu_utils import RelativeBucketedTimeAndPositionBias

jmod = importlib.import_module("torch_rechub_tpu.ops.pallas.hstu_attention")
tmod = importlib.import_module("torch_rechub_tpu_torch.ops.cuda.hstu_attention")

# The JAX package's own tolerances for this op (test_pallas_hstu.py:33,48):
# f32 sums of up to L terms taken in another order.
RTOL = ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
ALPHA, NORM = 0.35, 64.0


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def make_inputs(seed=0, b=2, h=3, l=64, dqk=16, dv=16, shared=False, mask="suffix", scale=0.3):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, h, l, dqk)) * scale).astype(np.float32)
    k = (rng.normal(size=(b, h, l, dqk)) * scale).astype(np.float32)
    v = (rng.normal(size=(b, h, l, dv)) * scale).astype(np.float32)
    bias = (rng.normal(size=(1 if shared else b, h, l, l)) * 0.1).astype(np.float32)
    if mask == "suffix":
        m = np.arange(l)[None, :] < rng.integers(l // 2, l + 1, (b, 1))
    elif mask == "scattered":  # with one fully masked row
        m = rng.uniform(size=(b, l)) > 0.3
        m[0] = False
    elif mask == "half":  # test_pallas_hstu.py:23-25
        m = np.ones((b, l), bool)
        m[0, l // 2:] = False
    else:
        m = None
    return q, k, v, bias, m


def to_torch(arrays, requires_grad=False):
    out = [None if a is None else torch.from_numpy(a) for a in arrays]
    if requires_grad:
        for t in out[:4]:
            t.requires_grad_(True)
    return out


def to_jax(arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def run_port(arrays, alpha=ALPHA, norm=NORM):
    return port_op(*to_torch(arrays), alpha, norm).numpy()


FWD_CASES = {
    "per_batch_suffix": dict(),
    "shared_suffix": dict(shared=True),
    "per_batch_scattered_empty_row": dict(mask="scattered"),
    "shared_scattered_empty_row": dict(mask="scattered", shared=True),
    "per_batch_no_mask": dict(mask=None),
    "shared_no_mask": dict(mask=None, shared=True),
    "ragged_77_dqk12_dv20": dict(l=77, dqk=12, dv=20, mask="scattered"),
    "jax_test_shape_B2H2L32D8": dict(b=2, h=2, l=32, dqk=8, dv=8, mask="half", scale=1.0),
}


@pytest.mark.parametrize("case", list(FWD_CASES))
def test_forward_matches_jax_op_and_reference(case):
    arrays = make_inputs(seed=1, **FWD_CASES[case])
    got = run_port(arrays)
    jarrays = to_jax(arrays)
    np.testing.assert_allclose(got, np.asarray(jmod.hstu_attention(*jarrays, ALPHA, NORM)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(jmod._xla_reference(*jarrays, ALPHA, NORM)), rtol=RTOL, atol=ATOL)
    assert got.shape == arrays[2].shape[:3] + (arrays[2].shape[3],)
    if FWD_CASES[case].get("mask") == "scattered":
        assert np.all(got[0] == 0)


def pallas_interpret(q, k, v, bias, mask, alpha, max_seq_len, block_q, block_k):
    """The TPU kernel body ``_fwd_kernel`` in interpret mode, with the plumbing of ``_pallas_forward``."""
    b, h, l, dqk = q.shape
    dv = v.shape[-1]
    bh = b * h
    if bias.shape[0] == 1:
        biasf = bias.reshape(h, l, l)
        bias_spec = pl.BlockSpec((1, block_q, l), lambda i, j: (i % h, j, 0))
    else:
        biasf = bias.reshape(bh, l, l)
        bias_spec = pl.BlockSpec((1, block_q, l), lambda i, j: (i, j, 0))
    out = pl.pallas_call(
        functools.partial(jmod._fwd_kernel, alpha=alpha, inv_n=1.0 / max_seq_len, block_q=block_q, block_k=block_k, seq_len=l),
        grid=(bh, l // block_q),
        in_specs=[
            pl.BlockSpec((1, block_q, dqk), lambda i, j: (i, j, 0)),
            pl.BlockSpec((1, l, dqk), lambda i, j: (i, 0, 0)),
            pl.BlockSpec((1, l, dv), lambda i, j: (i, 0, 0)),
            bias_spec,
            pl.BlockSpec((1, 1, l), lambda i, j: (i // h, 0, 0)),
        ],
        out_specs=pl.BlockSpec((1, block_q, dv), lambda i, j: (i, j, 0)),
        out_shape=jax.ShapeDtypeStruct((bh, l, dv), q.dtype),
        interpret=True,
    )(q.reshape(bh, l, dqk), k.reshape(bh, l, dqk), v.reshape(bh, l, dv), biasf, mask[:, None, :].astype(jnp.float32))
    return out.reshape(b, h, l, dv)


@pytest.mark.parametrize("shared", [False, True], ids=["per_batch", "shared"])
def test_plain_matches_the_pallas_kernel_body_in_interpret_mode(shared):
    arrays = make_inputs(seed=2, b=2, h=2, l=256, dqk=32, dv=32, shared=shared)
    got = run_port(arrays, alpha=0.2, norm=256.0)
    ref = pallas_interpret(*to_jax(arrays), 0.2, 256.0, block_q=128, block_k=256)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["per_batch_suffix", "shared_suffix", "per_batch_scattered_empty_row", "shared_no_mask"])
def test_gradients_match_jax_custom_vjp(case):
    arrays = make_inputs(seed=3, **FWD_CASES[case])
    q, k, v, bias, mask = to_torch(arrays, requires_grad=True)
    (port_op(q, k, v, bias, mask, ALPHA, NORM) ** 2).sum().backward()
    jq, jk, jv, jbias, jmask = to_jax(arrays)

    def loss(q, k, v, bias):
        return jnp.sum(jmod.hstu_attention(q, k, v, bias, jmask, ALPHA, NORM) ** 2)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(jq, jk, jv, jbias)
    assert bias.grad.shape == bias.shape == ref[3].shape  # (1, H, L, L) for a shared bias: summed over the batch
    for name, got, r in zip(("dq", "dk", "dv", "dbias"), (q, k, v, bias), ref):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(r), rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)


def test_nan_in_the_upper_triangle_and_at_masked_keys_stays_out():
    q, k, v, bias, mask = make_inputs(seed=4, mask="suffix")
    l = q.shape[2]
    bias = np.where(np.tril(np.ones((l, l), bool)), bias, np.nan).astype(np.float32)
    bias = np.where(mask[:, None, None, :], bias, np.nan).astype(np.float32)
    got = run_port((q, k, v, bias, mask))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(jmod.hstu_attention(*to_jax((q, k, v, bias, mask)), ALPHA, NORM)), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shared", [False, True], ids=["per_batch", "shared"])
def test_autograd_function_wiring_without_a_card(monkeypatch, shared):
    """``_AttentionKernel`` on CPU tensors, with the launch replaced by the plain version."""

    def fake_launch(q, k, v, bias, padding_mask, alpha, max_seq_len):
        tmod._check_kernel_inputs(q, k, v, bias, padding_mask)
        tmod.launches += 1
        return tmod.dense_forward(q, k, v, bias, padding_mask, alpha, max_seq_len)

    monkeypatch.setattr(tmod, "_launch", fake_launch)
    arrays = make_inputs(seed=5, shared=shared, mask="scattered")
    got = to_torch(arrays, requires_grad=True)
    ref = to_torch(arrays, requires_grad=True)
    g = torch.from_numpy(np.random.default_rng(6).normal(size=arrays[2].shape).astype(np.float32))
    before = tmod.launches
    out = tmod._AttentionKernel.apply(*got, ALPHA, NORM)
    assert tmod.launches == before + 1
    out.backward(g)
    assert tmod.launches == before + 1  # the backward recomputes with the plain version, no launch
    tmod.dense_forward(*ref, ALPHA, NORM).backward(g)
    np.testing.assert_array_equal(out.detach().numpy(), tmod.dense_forward(*to_torch(arrays), ALPHA, NORM).numpy())
    assert got[3].grad.shape == arrays[3].shape
    for a, b in zip(got[:4], ref[:4]):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)
    assert got[4].grad is None


@pytest.mark.parametrize("has_time", [True, False], ids=["time_and_position", "position_only"])
def test_materialised_rab_equals_the_on_the_fly_rab_op(has_time):
    b, h, l, d, maxl, nb = 2, 3, 96, 16, 128, 32
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy((rng.normal(size=(b, h, l, d)) * 0.3).astype(np.float32)) for _ in range(3))
    stamps = torch.from_numpy(np.sort(rng.integers(0, 10**6, (b, l)), axis=1).astype(np.int32))
    mask = torch.from_numpy(rng.uniform(size=(b, l)) > 0.2)
    module = RelativeBucketedTimeAndPositionBias(h, maxl, nb, "sqrt", 1.0, "minutes", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        bias = module(stamps) if has_time else module(seq_len=l)
        out = port_op(q, k, v, bias, mask, 1.0 / d**0.5, float(maxl))
        ref = trab.hstu_attention_rab(q, k, v, module.pos_w, module.ts_w, stamps if has_time else None, mask, 1.0 / d**0.5, maxl, trab.BucketCfg(nb))
    assert bias.shape[0] == (b if has_time else 1)
    torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
    # and the JAX package's on-the-fly op agrees with both
    jref = jrab._dense_forward(*(jnp.asarray(t.numpy()) for t in (q, k, v, module.pos_w.detach(), module.ts_w.detach())),
                               jnp.asarray(stamps.numpy()) if has_time else None, jnp.asarray(mask.numpy()), 1.0 / d**0.5, maxl,
                               jrab.BucketCfg(nb, "sqrt", 1.0, "minutes"), has_time)
    np.testing.assert_allclose(out.numpy(), np.asarray(jref), rtol=RTOL, atol=ATOL)


def test_op_on_cpu_is_the_plain_version_and_launches_nothing():
    arrays = make_inputs(seed=8)
    before = tmod.launches
    got = run_port(arrays)
    assert tmod.launches == before
    np.testing.assert_array_equal(got, tmod.dense_forward(*to_torch(arrays), ALPHA, NORM).numpy())


def test_op_takes_no_length_limit_from_max_seq_len():
    # max_seq_len is only the normaliser N: L may exceed it, as in the JAX op
    arrays = make_inputs(seed=9, l=48)
    np.testing.assert_allclose(run_port(arrays, norm=16.0), np.asarray(jmod._xla_reference(*to_jax(arrays), ALPHA, 16.0)), rtol=RTOL, atol=ATOL)


def test_op_rejects_other_devices():
    q = torch.empty((2, 3, 8, 16), device="meta")
    bias = torch.empty((2, 3, 8, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        port_op(q, q, q, bias, None, ALPHA, NORM)


def bad_inputs(case):
    q, k, v, bias, mask = to_torch(make_inputs(seed=10, b=3, l=16))
    if case == "bf16":
        q = q.to(torch.bfloat16)
    elif case == "non_contiguous_bias":
        bias = bias.transpose(2, 3)
    elif case == "bias_batch_2_of_3":
        bias = bias[:2].contiguous()
    elif case == "bias_wrong_length":
        bias = bias[:, :, :8, :8].contiguous()
    elif case == "dv_160":
        v = torch.zeros((*v.shape[:3], 160))
    elif case == "dqk_300":
        q = k = torch.zeros((*q.shape[:3], 300))
    elif case == "float_mask":
        mask = mask.float()
    elif case == "bias_on_meta":
        bias = bias.to("meta")
    return q, k, v, bias, mask


@pytest.mark.parametrize("case,error,match", [
    ("bf16", TypeError, "float32"),
    ("non_contiguous_bias", ValueError, "contiguous"),
    ("bias_batch_2_of_3", ValueError, "bias must be"),
    ("bias_wrong_length", ValueError, "bias must be"),
    ("float_mask", ValueError, "padding_mask"),
    ("bias_on_meta", ValueError, "is on meta"),
])
def test_kernel_input_checks(case, error, match):
    with pytest.raises(error, match=match):
        tmod._check_kernel_inputs(*bad_inputs(case))


@pytest.mark.parametrize("case", ["dv_160", "dqk_300"])
def test_kernel_input_checks_take_any_width(case):
    """No width is refused: past the tensor-core kernel's (dv 128, dqk 256) the entry takes its width-tiled variant."""
    tmod._check_kernel_inputs(*bad_inputs(case))


def test_kernel_input_checks_pass_both_bias_layouts():
    for shared in (False, True):
        q, k, v, bias, mask = to_torch(make_inputs(seed=11, shared=shared))
        tmod._check_kernel_inputs(q, k, v, bias, mask)
        tmod._check_kernel_inputs(q, k, v, bias, None)


class FakeLib:
    """Stands in for K3's ctypes library: records each entry's arguments, returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


@pytest.fixture
def fake_card(monkeypatch):
    """The launch path on CPU tensors: no card, the library and stream faked."""
    lib = FakeLib()
    monkeypatch.setattr(tmod, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: type("Stream", (), {"cuda_stream": 1234})())
    return lib


@pytest.mark.parametrize("shared,mask", [(False, "scattered"), (True, None)], ids=["per_batch", "shared_no_mask"])
def test_launch_hands_the_kernel_its_shapes_and_bias_layout(fake_card, shared, mask):
    q, k, v, bias, m = to_torch(make_inputs(seed=12, b=2, h=3, l=40, dqk=12, dv=20, shared=shared, mask=mask))
    before = tmod.launches
    out = tmod._launch(q, k, v, bias, m, ALPHA, NORM)
    assert tmod.launches == before + 1 and out.shape == (2, 3, 40, 20)
    (name, args), = fake_card.calls
    assert name == "hstu_attn_fwd"
    assert args[:6] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), None if m is None else m.data_ptr(), out.data_ptr())
    # B, H, L, dqk, dv, shared_bias, alpha, norm, stream (then where the entry reports the variant it took)
    assert args[6:-1] == (2, 3, 40, 12, 20, int(shared), ALPHA, NORM, 1234)


def test_occupancy_asks_the_kernel_for_its_shape(fake_card):
    assert tmod.occupancy(1024, 256, 128) == (0, 0, 0, "tensor-core")  # the fake fills nothing in
    (name, args), = fake_card.calls
    assert name == "hstu_attn_fwd_occupancy" and args[:3] == (1024, 256, 128) and len(args[3]) == 5
