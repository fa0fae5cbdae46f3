"""The bf16 variants of K2a, K2b (the split rab backward) and K3 (the materialised-bias forward) in the port,
against the JAX package on the CPU.

- The split pair's plain bf16 backward (``plain_backward_bf16``, which the CPU path of ``rab_backward_dq`` /
  ``rab_backward_dkv`` takes) against the Pallas kernels ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel`` in interpret
  mode, reached through the JAX op's VJP with ``_FUSED_BWD[0] = False``.
- K3's ``plain_forward_bf16`` against the Pallas body ``_fwd_kernel`` in interpret mode on bf16 inputs, and the
  op's bf16 gradients against ``jax.vjp`` of the JAX op.
- One bf16 chunked ``SeqTrainer`` step of a small HSTU through the split backward on both sides.
- The wrappers' launch plumbing on CPU tensors with the libraries faked: the new entries get their shapes,
  dtypes, bias layout and output buffers, and their own launch counters.

The kernels themselves run only on the card (``tests/test_torch_cuda_precision.py``).  Inputs are made with
numpy from a seed and handed to both packages.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_hstu_attention import pallas_interpret
from test_torch_precision import (HSTU_CHUNK, HSTU_KW, assert_bf16_like_jax, assert_f32_state, assert_grads_like_jax, f32, hstu_data, jax_grads,
                                  np_tree, port_step)
from torch_rechub_tpu.models.generative.hstu import HSTUModel as JHSTUModel
from torch_rechub_tpu.ops import chunked_ce as jce
from torch_rechub_tpu.ops.pallas import hstu_rab_attention as jrab
from torch_rechub_tpu_torch.basic import precision as tprec
from torch_rechub_tpu_torch.models.generative.hstu import HSTUModel
from torch_rechub_tpu_torch.ops.cuda import hstu_rab_attention as trab
from torch_rechub_tpu_torch.trainers import SeqTrainer
from torch_rechub_tpu_torch.utils import data as tdata
from torch_rechub_tpu_torch.utils.jax_weights import load_flax_params

jmod = importlib.import_module("torch_rechub_tpu.ops.pallas.hstu_attention")
tmod = importlib.import_module("torch_rechub_tpu_torch.ops.cuda.hstu_attention")

BF16 = torch.bfloat16
# a bf16 tensor against JAX's: one bf16 ulp (2**-7 of the largest element's binade) of the largest element, since
# a rounding of attn or ds, or of an f32 sum taken in another order, may flip; an f32 sum (a table gradient of up
# to B*L^2/2 terms, K3's f32 dbias) taken in another order to 1e-5 of its largest element
ULP_REL, F32_REL = 2**-7, 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def split_interpret():
    """The JAX op on its Pallas kernels in interpret mode, backward through the split pair; both flags restored."""
    jrab._FORCE_INTERPRET[0], jrab._FUSED_BWD[0] = True, False
    yield
    jrab._FORCE_INTERPRET[0], jrab._FUSED_BWD[0] = False, True


# ---------------------------------------------------------------------------
# (a) the split pair's plain bf16 backward against _pallas_backward_qkv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("has_time", [True, False], ids=["time", "position_only"])
def test_split_plain_bf16_matches_pallas_interpret(split_interpret, monkeypatch, has_time):
    """L128, two heads, one row padded, blocks of 32 so both kernels walk several tiles.  dq, dk, dv in bf16 to one
    bf16 ulp of the largest element, dpos and dts in f32 to 1e-5 of theirs, each nearer to JAX-bf16 than a quarter
    of JAX-bf16's distance to JAX-f32; the wrappers' CPU path equals the plain version."""
    b, h, l, d, maxl = 2, 2, 128, 16, 160
    rng = np.random.default_rng(1)
    q, k, v, g = (rng.normal(size=(b, h, l, d)).astype(np.float32) for _ in range(4))
    pos_w = (rng.normal(size=(2 * maxl - 1, h)) * 0.3).astype(np.float32)
    ts_w = (rng.normal(size=(9, h)) * 0.3).astype(np.float32)
    ts = np.sort(rng.integers(0, 100_000, (b, l)), axis=1).astype(np.int32)
    mask = np.ones((b, l), bool)
    mask[1, :40] = False
    cfg, tcfg = jrab.BucketCfg(8, "sqrt", 1.0, "minutes"), trab.BucketCfg(8, "sqrt", 1.0, "minutes")
    calls = []
    real = jrab._pallas_backward_qkv
    monkeypatch.setattr(jrab, "_pallas_backward_qkv", lambda *a: calls.append(a[-1]) or real(*a))

    def run(dtype):
        f = lambda qq, kk, vv, pw, tw: jrab.hstu_attention_rab(qq, kk, vv, pw, tw, jnp.asarray(ts) if has_time else None, jnp.asarray(mask), 0.25, maxl, cfg, 32, 32)  # noqa: E731
        _, vjp = jax.vjp(f, *(jnp.asarray(a, dtype) for a in (q, k, v)), jnp.asarray(pos_w), jnp.asarray(ts_w))
        return vjp(jnp.asarray(g, dtype))

    j16, j32 = run(jnp.bfloat16), run(jnp.float32)
    assert calls == [True, True]  # both backwards went through the split Pallas pair, in interpret mode
    tq, tk, tv, tg = (torch.from_numpy(a).to(BF16) for a in (q, k, v, g))
    targs = (torch.from_numpy(pos_w), torch.from_numpy(ts_w), torch.from_numpy(ts) if has_time else None, torch.from_numpy(mask), 0.25, maxl, tcfg)
    port = trab.plain_backward_bf16(tq, tk, tv, tg, *targs, has_time)
    for name, p, r16, r32 in zip(("dq", "dk", "dv", "dpos", "dts"), port, j16, j32):
        bf16 = name in ("dq", "dk", "dv")
        assert p.dtype == (BF16 if bf16 else torch.float32) and r16.dtype == (jnp.bfloat16 if bf16 else jnp.float32), name
        if not has_time and name == "dts":
            assert not p.any() and not np.asarray(r16).any()
            continue
        scale = float(np.abs(f32(r16)).max())
        assert_bf16_like_jax(p, r16, r32, 0, scale * (ULP_REL if bf16 else F32_REL), name)
    args = (tq, tk, tv, tg) + targs
    got = trab.rab_backward_dq(*args) + trab.rab_backward_dkv(*args)
    for a, r in zip(got, (port[0], port[3], port[4], port[1], port[2])):
        assert torch.equal(a, r)


# ---------------------------------------------------------------------------
# (b) K3's plain bf16 forward against its Pallas body, and the op's bf16 gradients
# ---------------------------------------------------------------------------

def k3_inputs(seed, shared, bias_dtype, b=2, h=2, l=64, dqk=16, dv=24):
    """bf16-valued q, k, v (as f32 numpy), a bias of ``bias_dtype``'s values, a scattered mask with one fully
    masked row."""
    rng = np.random.default_rng(seed)
    q, k, v = (f32(torch.from_numpy((rng.normal(size=(b, h, l, w)) * s).astype(np.float32)).to(BF16)) for w, s in ((dqk, 0.6), (dqk, 0.6), (dv, 1.0)))
    bias = f32(torch.from_numpy((rng.normal(size=(1 if shared else b, h, l, l)) * 0.5).astype(np.float32)).to(bias_dtype))
    mask = rng.uniform(size=(b, l)) > 0.3
    mask[0] = False
    return q, k, v, bias, mask


K3_CASES = {f"{'shared' if shared else 'per_batch'}_{name}_bias": (shared, dtype) for shared in (False, True) for name, dtype in (("f32", torch.float32), ("bf16", BF16))}


@pytest.mark.parametrize("case", list(K3_CASES))
def test_k3_plain_bf16_matches_pallas_interpret(case):
    """The Pallas body on bf16 q, k, v and the bias in its dtype (``attn`` kept f32 against a bf16 v, the output
    rounded to bf16) against ``plain_forward_bf16`` and the op's CPU path: one bf16 ulp of the largest element,
    and nearer than a quarter of the way to the body's f32 output on the same values; a fully masked row zero."""
    shared, bias_dtype = K3_CASES[case]
    q, k, v, bias, mask = k3_inputs(2, shared, bias_dtype)
    jbias = jnp.asarray(bias, jnp.bfloat16 if bias_dtype == BF16 else jnp.float32)
    ref16 = pallas_interpret(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jbias, jnp.asarray(mask), 0.3, 64.0, block_q=32, block_k=64)
    ref32 = pallas_interpret(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(bias), jnp.asarray(mask), 0.3, 64.0, block_q=32, block_k=64)
    assert ref16.dtype == jnp.bfloat16
    tq, tk, tv = (torch.from_numpy(a).to(BF16) for a in (q, k, v))
    tbias, tmask = torch.from_numpy(bias).to(bias_dtype), torch.from_numpy(mask)
    got = tmod.plain_forward_bf16(tq, tk, tv, tbias, tmask, 0.3, 64.0)
    assert got.dtype == BF16
    assert_bf16_like_jax(got, ref16, ref32, 0, ULP_REL * float(np.abs(f32(ref16)).max()), case)
    assert not got[0].any()
    before = (tmod.launches, tmod.launches_bf16)
    assert torch.equal(tmod.hstu_attention(tq, tk, tv, tbias, tmask, 0.3, 64.0), got)
    assert (tmod.launches, tmod.launches_bf16) == before  # the CPU launches nothing


@pytest.mark.parametrize("case", ["per_batch_f32_bias", "shared_bf16_bias"])
def test_k3_bf16_gradients_match_jax_vjp(case):
    """The op's backward on bf16 leaves (autograd of the plain ``dense_forward``, the mirror of ``_xla_reference``)
    against ``jax.vjp`` of the JAX op on the same bf16 values, whose backward differentiates ``_xla_reference`` on
    every backend: dq, dk, dv and dbias (a shared bias's summed over the batch) in the leaves' dtypes, a bf16 one to
    one bf16 ulp of its largest element, an f32 one to 1e-5, each nearer to JAX-bf16 than a quarter of JAX-bf16's
    distance to JAX-f32 (``dense_forward`` rounds where ``_xla_reference`` does: ``q @ k``, the weak scalars,
    silu's steps)."""
    shared, bias_dtype = K3_CASES[case]
    q, k, v, bias, mask = k3_inputs(3, shared, bias_dtype)
    g = np.random.default_rng(4).normal(size=v.shape).astype(np.float32)
    g = f32(torch.from_numpy(g).to(BF16))
    jdt = jnp.bfloat16 if bias_dtype == BF16 else jnp.float32

    def jgrads(dtype, bdtype):
        f = lambda *a: jmod.hstu_attention(*a, jnp.asarray(mask), 0.3, 64.0)  # noqa: E731
        out, vjp = jax.vjp(f, *(jnp.asarray(a, dtype) for a in (q, k, v)), jnp.asarray(bias, bdtype))
        return vjp(jnp.asarray(g, out.dtype))

    j16, j32 = jgrads(jnp.bfloat16, jdt), jgrads(jnp.float32, jnp.float32)
    leaves = [torch.from_numpy(a).to(dt).requires_grad_(True) for a, dt in zip((q, k, v, bias), (BF16, BF16, BF16, bias_dtype))]
    out = tmod.hstu_attention(*leaves, torch.from_numpy(mask), 0.3, 64.0)
    assert out.dtype == BF16
    out.backward(torch.from_numpy(g).to(BF16))
    for name, leaf, r16, r32 in zip(("dq", "dk", "dv", "dbias"), leaves, j16, j32):
        assert leaf.grad.dtype == leaf.dtype and leaf.grad.shape == leaf.shape and r16.dtype == (jnp.bfloat16 if leaf.dtype == BF16 else jnp.float32), name
        scale = float(np.abs(f32(r16)).max())
        assert_bf16_like_jax(leaf.grad, r16, r32, 0, scale * (ULP_REL if leaf.dtype == BF16 else F32_REL), name)


# ---------------------------------------------------------------------------
# (c) one bf16 HSTU step through the split backward, against the JAX trainer's
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def hstu_jax_split():
    """The JAX package's chunked bf16 and f32 step on a small HSTU, its backward through the split Pallas pair in
    interpret mode (``test_torch_precision.hstu_jax`` with ``_FUSED_BWD[0] = False``)."""
    toks, _, tgts, tds = hstu_data()
    jmodel = JHSTUModel(**HSTU_KW)
    params = np_tree(jmodel.init(jax.random.PRNGKey(1), jnp.asarray(toks[:1]), jnp.asarray(tds[:1]))["params"])

    def jloss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(toks), jnp.asarray(tds), training=True, return_hidden=True)
        return jce.chunked_next_token_loss(out["hidden"], out["weight"], jnp.asarray(toks), jnp.asarray(tgts), out["bias"], 1.0, 0, HSTU_CHUNK), out["hidden"]

    jrab._FORCE_INTERPRET[0], jrab._FUSED_BWD[0] = True, False
    try:
        return params, jax_grads(jloss, params)
    finally:
        jrab._FORCE_INTERPRET[0], jrab._FUSED_BWD[0] = False, True


def test_hstu_bf16_split_step_matches_jax(monkeypatch):
    """``SeqTrainer(precision="bf16")`` with ``_FUSED_BWD[0] = False`` (its layers' backward through
    ``rab_backward_dq`` and ``rab_backward_dkv``) against the JAX trainer's loss and gradients through
    ``_pallas_backward_qkv``: the loss and the hidden states to the bit or one ulp, the gradients as
    ``test_torch_precision.py`` holds the fused step's; then an epoch, with parameters and optimizer state f32."""
    params, ref = hstu_jax_split()
    toks, pos, tgts, tds = hstu_data()
    monkeypatch.setattr(trab, "_FUSED_BWD", [False])
    split_calls = []
    for name in ("rab_backward_dq", "rab_backward_dkv"):
        real = getattr(trab, name)
        monkeypatch.setattr(trab, name, lambda *a, real=real, name=name: split_calls.append(name) or real(*a))
    model = load_flax_params(HSTUModel(**HSTU_KW), params)
    trainer = SeqTrainer(model, vocab_chunk_size=HSTU_CHUNK, precision="bf16", device="cpu")
    model.train()
    batch = [torch.from_numpy(a) for a in (toks, tds, tgts)]

    def loss_fn():
        out = model(batch[0], batch[1], return_hidden=True)
        return trainer.loss_fn(*batch), out["hidden"]

    loss, hidden = port_step(model, loss_fn)
    assert sorted(split_calls) == ["rab_backward_dkv"] * HSTU_KW["n_layers"] + ["rab_backward_dq"] * HSTU_KW["n_layers"]
    assert_bf16_like_jax(loss, ref["bf16"][0], ref["f32"][0], 1e-6, 1e-6, "loss")
    assert_bf16_like_jax(hidden, ref["bf16"][1], ref["f32"][1], 0, 2**-7, "hidden")
    key_biases = {name for name, _ in model.named_parameters() if name.endswith("W_K.bias")}  # exact gradient 0
    assert_grads_like_jax(dict(model.named_parameters()), ref["bf16"][2], ref["f32"][2], key_biases)
    trainer.train_one_epoch(tdata.SeqLoader(toks, pos, tgts, tds, batch_size=4), log_interval=0)
    assert_f32_state(trainer)
    assert tprec.precision() == "float32"


# ---------------------------------------------------------------------------
# (d) the launch plumbing of the new entries, the libraries faked
# ---------------------------------------------------------------------------

class FakeLib:
    """Stands in for a kernel library: records each entry's arguments, returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


@pytest.fixture
def fake_card(monkeypatch):
    """The launch paths on CPU tensors: no card; the libraries, the device context and the stream faked; the rab
    backward wrappers told to launch (``_dispatch_bwd`` returns the thresholds, not the plain version)."""
    lib = FakeLib()
    for mod, name in ((trab, "_lib_bf16"), (trab, "_lib_bwd_bf16"), (tmod, "_lib_bf16")):
        monkeypatch.setattr(mod, name, lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: type("Stream", (), {"cuda_stream": 1234})())
    monkeypatch.setattr(trab, "_dispatch_bwd", lambda name, *args: (None, args[-1]))
    return lib


def rab_bf16_inputs(b=2, h=3, l=40, dqk=12, dv=20, maxl=48, nb=16):
    gen = torch.Generator().manual_seed(0)
    q, k = (torch.randn(b, h, l, dqk, generator=gen).to(BF16) for _ in range(2))
    v, g = (torch.randn(b, h, l, dv, generator=gen).to(BF16) for _ in range(2))
    cfg = trab.BucketCfg(nb, "log", 2.0, "seconds")
    tables = (torch.randn(2 * maxl - 1, h, generator=gen), torch.randn(nb + 1, h, generator=gen))
    ts = torch.randint(0, 10**6, (b, l), generator=gen, dtype=torch.int32)
    mask = torch.rand(b, l, generator=gen) > 0.3
    return (q, k, v, g) + tables + (ts, mask, 0.3, maxl, cfg, trab.compute_bucket_thresholds(cfg))


def test_split_bf16_wrappers_hand_the_kernels_their_buffers(fake_card):
    """``rab_backward_dq`` on bf16 inputs launches ``hstu_rab_bwd_dq_bf16`` into a bf16 dq and zeroed f32 dpos,
    dts (no dk, dv); ``rab_backward_dkv`` launches ``hstu_rab_bwd_dkv_bf16`` into bf16 dk, dv (nothing else);
    each counts on its own counter."""
    args = rab_bf16_inputs()
    q, k, v, g, pos_w, ts_w, ts, mask, alpha, maxl, cfg, thr = args
    counts = (trab.launches_bwd_dq, trab.launches_bwd_dkv, trab.launches_bwd_dq_bf16, trab.launches_bwd_dkv_bf16)
    dq, dpos, dts = trab.rab_backward_dq(*args)
    dk, dv = trab.rab_backward_dkv(*args)
    assert (trab.launches_bwd_dq, trab.launches_bwd_dkv, trab.launches_bwd_dq_bf16, trab.launches_bwd_dkv_bf16) == (counts[0], counts[1], counts[2] + 1, counts[3] + 1)
    assert (dq.dtype, dk.dtype, dv.dtype, dpos.dtype, dts.dtype) == (BF16,) * 3 + (torch.float32,) * 2
    assert (dq.shape, dk.shape, dv.shape, dpos.shape, dts.shape) == (q.shape, k.shape, v.shape, pos_w.shape, ts_w.shape)
    assert not dpos.any() and not dts.any()  # zeroed: the kernel adds its sums with atomics
    (n1, a1), (n2, a2) = fake_card.calls
    assert (n1, n2) == ("hstu_rab_bwd_dq_bf16", "hstu_rab_bwd_dkv_bf16")
    inputs = tuple(t.data_ptr() for t in (q, k, v, g, pos_w, ts_w, thr, ts, mask))
    assert a1[:14] == inputs + (dq.data_ptr(), None, None, dpos.data_ptr(), dts.data_ptr())
    assert a2[:14] == inputs + (None, dk.data_ptr(), dv.data_ptr(), None, None)
    # B, H, L, dqk, dv, max_seq_len, num_buckets, alpha, fn_log, minutes, divisor, stream
    scalars = (2, 3, 40, 12, 20, maxl, 16, alpha, 1, 0, 2.0, 1234)
    assert a1[14:] == a2[14:] == scalars


def test_split_backward_of_the_op_takes_the_bf16_pair(fake_card, monkeypatch):
    """The autograd Function with ``_FUSED_BWD[0] = False`` on bf16 leaves: the forward the plain bf16 version
    (CPU tensors), the backward K2a-bf16 then K2b-bf16, gradients in the leaves' dtypes."""
    q, k, v, g, pos_w, ts_w, ts, mask, alpha, maxl, cfg, thr = rab_bf16_inputs()
    monkeypatch.setattr(trab, "_FUSED_BWD", [False])
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, pos_w, ts_w)]
    counts = (trab.launches_bwd_bf16, trab.launches_bwd_dq_bf16, trab.launches_bwd_dkv_bf16)
    trab._RabAttentionKernel.apply(*leaves, ts, mask, thr, alpha, maxl, cfg).backward(g)
    assert [name for name, _ in fake_card.calls] == ["hstu_rab_bwd_dq_bf16", "hstu_rab_bwd_dkv_bf16"]
    assert (trab.launches_bwd_bf16, trab.launches_bwd_dq_bf16, trab.launches_bwd_dkv_bf16) == (counts[0], counts[1] + 1, counts[2] + 1)
    assert [x.grad.dtype for x in leaves] == [BF16] * 3 + [torch.float32] * 2


@pytest.mark.parametrize("shared,bias_dtype,masked", [(False, torch.float32, True), (True, BF16, False), (False, BF16, True), (True, torch.float32, True)],
                         ids=["per_batch_f32", "shared_bf16_no_mask", "per_batch_bf16", "shared_f32"])
def test_k3_bf16_launch_hands_the_kernel_its_shapes_and_bias_layout(fake_card, shared, bias_dtype, masked):
    b, h, l, dqk, dv = 2, 3, 40, 12, 20
    gen = torch.Generator().manual_seed(1)
    q, k = (torch.randn(b, h, l, dqk, generator=gen).to(BF16) for _ in range(2))
    v = torch.randn(b, h, l, dv, generator=gen).to(BF16)
    bias = torch.randn(1 if shared else b, h, l, l, generator=gen).to(bias_dtype)
    mask = torch.rand(b, l, generator=gen) > 0.3 if masked else None
    before = (tmod.launches, tmod.launches_bf16)
    out = tmod._launch(q, k, v, bias, mask, 0.3, 64.0)
    assert (tmod.launches, tmod.launches_bf16) == (before[0], before[1] + 1)
    assert out.dtype == BF16 and out.shape == (b, h, l, dv)
    (name, args), = fake_card.calls
    assert name == "hstu_attn_fwd_bf16"
    assert args[:6] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), None if mask is None else mask.data_ptr(), out.data_ptr())
    # B, H, L, dqk, dv, shared_bias, bias_bf16, alpha, norm, stream
    assert args[6:] == (b, h, l, dqk, dv, int(shared), int(bias_dtype == BF16), 0.3, 64.0, 1234)


def test_launch_shape_reads_the_ring_stages_from_a_fourth_field(fake_card, monkeypatch):
    """``launch_shape_bf16`` asks K1-bf16 or, by index, K2-bf16 (0), K2a-bf16 (1) or K2b-bf16 (2) into a four-int
    buffer, and returns all four fields (a name that is no bf16 rab kernel is refused); ``occupancy_bf16`` keeps
    returning three."""
    stages = {(): 2, (0,): 1, (1,): 1, (2,): 2}  # the kernel's index -> the stages the fake reports

    def query(*args):
        which, info = args[:-6], args[-1]
        fake_card.calls.append((which, args[-6:-1]))
        assert len(info) == 4
        info[0], info[1], info[2], info[3] = 3, 80, 40_000, stages.get(which, 0)
        return 0

    lib = type("Lib", (), {"hstu_rab_fwd_bf16_occupancy": staticmethod(query), "hstu_rab_bwd_bf16_occupancy": staticmethod(query)})()
    monkeypatch.setattr(trab, "_lib_bf16", lambda: lib)
    monkeypatch.setattr(trab, "_lib_bwd_bf16", lambda: lib)
    shape = (4096, 128, 128, 4096, 128)
    names = ("hstu_rab_fwd_bf16",) + trab.BWD_ENTRIES_BF16
    got = {name: trab.launch_shape_bf16(name, *shape) for name in names}
    assert got == {"hstu_rab_fwd_bf16": (3, 80, 40_000, 2), "hstu_rab_bwd_bf16": (3, 80, 40_000, 1), "hstu_rab_bwd_dq_bf16": (3, 80, 40_000, 1),
                   "hstu_rab_bwd_dkv_bf16": (3, 80, 40_000, 2)}
    assert fake_card.calls == [((), shape), ((0,), shape), ((1,), shape), ((2,), shape)]
    with pytest.raises(ValueError, match="not a bf16 rab kernel"):
        trab.launch_shape_bf16("hstu_rab_fwd", *shape)
    assert trab.occupancy_bf16(256, 32, 32, 256, 128)["hstu_rab_fwd_bf16"] == (3, 80, 40_000)


def test_bf16_occupancy_queries_name_every_kernel(fake_card):
    """``occupancy_bf16`` asks for K1-bf16 and, by index, K2-, K2a- and K2b-bf16; K3-bf16's for its bias dtype (with
    its ring stages in a fourth field)."""
    assert trab.occupancy_bf16(256, 32, 32, 256, 128) == {name: (0, 0, 0) for name in ("hstu_rab_fwd_bf16",) + trab.BWD_ENTRIES_BF16}
    assert tmod.occupancy_bf16(1024, 256, 128, bias_bf16=True) == (0, 0, 0, 0)
    calls = [(name, args[:-1]) for name, args in fake_card.calls]
    assert calls == [("hstu_rab_fwd_bf16_occupancy", (256, 32, 32, 256, 128))] + [("hstu_rab_bwd_bf16_occupancy", (which, 256, 32, 32, 256, 128)) for which in range(3)] + [
        ("hstu_attn_fwd_bf16_occupancy", (1024, 256, 128, 1))]
