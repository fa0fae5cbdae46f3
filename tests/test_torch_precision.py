"""bf16 mixed precision (``basic/precision.py``) in the port against the JAX package on the CPU.

What ``tests/test_precision.py`` pins for the JAX package, held here against
it: the scope switches and restores, every trainer refuses an unknown
precision eagerly, a bf16 ``Dense`` equals flax's bit for bit, the
activations round as XLA rounds them, the plain bf16 versions of K1 and K2
equal the Pallas kernels in interpret mode, and one bf16 chunked HSTU step
and its ``evaluate`` match the JAX package's under
``precision_scope("bf16")``, with parameters and optimizer state kept
float32.  The other models' bf16 steps are in
``tests/test_torch_precision_models.py``, with these helpers.

Every comparison also checks that the port computed bf16 at all: the
distance of the port's loss or outputs to JAX-bf16 is at most a quarter of
JAX-bf16's distance to JAX-f32 (``assert_bf16_like_jax``), so a port that
silently stayed in f32 fails.

Gradients get a looser, stated tolerance than the forward.  The forward
rounds where flax rounds and matches to the bit or nearly; XLA's CPU
backend, though, sums a bf16 reduction (a bias gradient, the gradient of a
broadcast, a ``dot`` transposed into a long contraction) with a rounding
to bf16 after every add, in its own tree order, while PyTorch sums in f32
and rounds once.  So a gradient element may differ by a few bf16 ulps of
its tensor's largest element, and the whole gradient is held to be closer
to JAX-bf16 than JAX-f32 is.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cuda_matching import build_match
from test_torch_cuda_mtl import TASK_TYPES, build_mtl
from test_torch_cuda_ranking import build
from torch_rechub_tpu.basic.precision import precision_scope as jscope
from torch_rechub_tpu.models.generative.hstu import HSTUModel as JHSTUModel
from torch_rechub_tpu.ops import chunked_ce as jce
from torch_rechub_tpu.ops.pallas import hstu_rab_attention as jrab
from torch_rechub_tpu_torch.basic import features as tfeat
from torch_rechub_tpu_torch.basic import precision as tprec
from torch_rechub_tpu_torch.basic.layers import MLP
from torch_rechub_tpu_torch.models import matching as tmatching
from torch_rechub_tpu_torch.models import multi_task as tmt
from torch_rechub_tpu_torch.models import ranking as tranking
from torch_rechub_tpu_torch.models.generative.hstu import HSTUModel
from torch_rechub_tpu_torch.ops.cuda import hstu_rab_attention as trab
from torch_rechub_tpu_torch.trainers import CTRTrainer, MatchTrainer, MTLTrainer, SeqTrainer
from torch_rechub_tpu_torch.utils import data as tdata
from torch_rechub_tpu_torch.utils.jax_weights import flax_to_state_dict, load_flax_params

BF16 = torch.bfloat16
# the quarter rule: |port - JAX-bf16| <= QUARTER * |JAX-bf16 - JAX-f32|
QUARTER = 0.25
# a gradient element against JAX-bf16: a few bf16 ulps (2**-8 relative) of its tensor's largest element,
# for the bf16 reductions XLA's CPU backend rounds at every add (module docstring)
GRAD_ATOL_REL = 2**-5
# the whole gradient: closer to JAX-bf16 than JAX-f32 is, by at least this factor
GRAD_NORM_RATIO = 0.75
# HSTU at the Pallas kernels' block (128): the JAX side runs them in interpret mode at L128
HSTU_L, HSTU_VOCAB, HSTU_CHUNK = 128, 50, 16
HSTU_KW = dict(vocab_size=HSTU_VOCAB, d_model=32, n_heads=2, n_layers=2, dqk=16, dv=16, max_seq_len=HSTU_L, dropout=0.0, num_time_buckets=8)


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def assert_bf16_like_jax(port, j16, j32, rtol, atol, what):
    """``port`` within (rtol, atol) of JAX-bf16, and nearer to it than a quarter of JAX-bf16's distance to JAX-f32."""
    port, j16, j32 = f32(port), f32(j16), f32(j32)
    np.testing.assert_allclose(port, j16, rtol=rtol, atol=atol, err_msg=what)
    gap = float(np.linalg.norm(j16 - j32))
    assert gap > 0, f"{what}: JAX's bf16 and f32 results agree, the case shows nothing"
    assert float(np.linalg.norm(port - j16)) <= QUARTER * gap, (what, float(np.linalg.norm(port - j16)), gap)


def before_batchnorm(model):
    """The biases of the ``Dense`` layers in front of an MLP's BatchNorm: their exact gradient is 0, so what
    either package computes for them is rounding noise, not compared."""
    return {f"{name}.Dense_{i}.bias" for name, m in model.named_modules() if isinstance(m, MLP) for i in range(len(m.dims))}


def assert_grads_like_jax(named, g16, g32, skip=()):
    """Each gradient within GRAD_ATOL_REL of its JAX-bf16 tensor's largest element; all of them, as one vector,
    nearer to JAX-bf16 than GRAD_NORM_RATIO of JAX-f32's distance.  ``skip``: names not compared."""
    num = den = 0.0
    for name, p in named.items():
        if name in skip:
            continue
        got, r16, r32 = p.grad.numpy(), g16[name].numpy(), g32[name].numpy()
        np.testing.assert_allclose(got, r16, rtol=0, atol=GRAD_ATOL_REL * float(np.abs(r16).max()) + 1e-12, err_msg=name)
        num += float(np.sum((got - r16) ** 2))
        den += float(np.sum((r16 - r32) ** 2))
    assert num <= GRAD_NORM_RATIO**2 * den, (num**0.5, den**0.5)


def jax_grads(jloss, params):
    """``{prec: (loss, aux, grads as a state_dict)}`` of ``jloss(params) -> (loss, aux)`` under bf16 and f32."""
    out = {}
    for prec in ("bf16", "f32"):
        with jscope(prec):
            (loss, aux), grads = jax.value_and_grad(jloss, has_aux=True)(params)
        out[prec] = (float(loss), aux, flax_to_state_dict(np_tree(grads)))
    return out


def port_step(model, loss_fn):
    """The port's ``(loss, aux)`` of ``loss_fn()`` under bf16, its gradients left on the parameters."""
    model.zero_grad(set_to_none=True)
    with tprec.precision_scope("bf16"):
        loss, aux = loss_fn()
    loss.backward()
    return loss, aux


def assert_f32_state(trainer):
    assert {p.dtype for p in trainer.model.parameters()} == {torch.float32}
    assert {b.dtype for b in trainer.model.buffers() if b.is_floating_point()} <= {torch.float32}
    opt = trainer.optimizer.optimizers if hasattr(trainer.optimizer, "optimizers") else (trainer.optimizer,)
    states = [v for o in opt for s in o.state.values() for v in s.values() if torch.is_tensor(v) and v.is_floating_point() and v.ndim > 0]
    assert states and {v.dtype for v in states} == {torch.float32}


# ---------------------------------------------------------------------------
# the policy
# ---------------------------------------------------------------------------

def test_scope_switches_and_restores():
    assert tprec.compute_dtype() == torch.float32
    with tprec.precision_scope("bf16"):
        assert tprec.compute_dtype() == BF16 and tprec.precision() == "bfloat16"
        with tprec.precision_scope("f32"):
            assert tprec.compute_dtype() == torch.float32
        assert tprec.compute_dtype() == BF16
        with tprec.precision_scope(None):
            assert tprec.compute_dtype() == BF16
    assert tprec.compute_dtype() == torch.float32
    with pytest.raises(RuntimeError), tprec.precision_scope("mixed"):
        raise RuntimeError("leaves the scope")
    assert tprec.precision() == "float32"
    with pytest.raises(ValueError):
        tprec.set_precision("fp8")
    assert tprec.cast_compute(torch.ones(2, dtype=torch.int32)).dtype == torch.int32
    with tprec.precision_scope("bf16"):
        assert tprec.cast_compute(torch.ones(2)).dtype == BF16
        assert tprec.cast_compute(None) is None


def trainer_of(kind):
    if kind == "SeqTrainer":
        return lambda **kw: SeqTrainer(HSTUModel(**HSTU_KW), **kw)
    if kind == "CTRTrainer":
        return lambda **kw: CTRTrainer(build(tranking, tfeat, "DeepFM"), **kw)
    if kind == "MatchTrainer":
        return lambda **kw: MatchTrainer(build_match(tmatching, tfeat, "DSSM"), **kw)
    return lambda **kw: MTLTrainer(build_mtl(tmt, tfeat, "MMOE"), TASK_TYPES, **kw)


@pytest.mark.parametrize("kind", ["SeqTrainer", "CTRTrainer", "MatchTrainer", "MTLTrainer"])
def test_every_trainer_validates_precision_eagerly(kind):
    make = trainer_of(kind)
    with pytest.raises(ValueError, match="precision"):
        make(precision="fp8", device="cpu")
    for name in ("bf16", "mixed", "f32", None):
        assert make(precision=name, device="cpu").precision == name
    assert tprec.precision() == "float32"  # making a trainer sets no policy


def test_bf16_dense_matches_flax_bit_for_bit():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 256)).astype(np.float32)
    dense = fnn.Dense(128, dtype=jnp.bfloat16)
    params = np_tree(dense.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params["params"]["bias"] = rng.normal(size=128).astype(np.float32)
    ref = f32(dense.apply(params, jnp.asarray(x)))
    layer = tprec.Dense(256, 128)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(params["params"]["kernel"].T))
        layer.bias.copy_(torch.from_numpy(params["params"]["bias"]))
    with tprec.precision_scope("bf16"):
        out = layer(torch.from_numpy(x))
    assert out.dtype == BF16
    np.testing.assert_array_equal(f32(out), ref)
    assert layer(torch.from_numpy(x)).dtype == torch.float32  # outside the scope: F.linear in f32


@pytest.mark.parametrize("fn", ["sigmoid", "silu", "softmax"])
def test_bf16_activations_match_jax(fn):
    """``jax.nn`` on bf16 as XLA's CPU backend rounds it: the values bit for bit; the gradients bit for bit
    but softmax's, whose backward sums ``g * u`` over the row in bf16 with a rounding at every add in XLA
    and in f32 here, held to GRAD_ATOL_REL of its largest element."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(16, 24)).astype(np.float32) * 3
    g = rng.normal(size=(16, 24)).astype(np.float32)
    xb, gb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    jfn, tfn = {"sigmoid": (jax.nn.sigmoid, tprec.sigmoid), "silu": (jax.nn.silu, tprec.silu),
                "softmax": (lambda a: jax.nn.softmax(a, axis=-1), lambda a: tprec.softmax(a, dim=-1))}[fn]
    ref, vjp = jax.vjp(jfn, xb)
    t = torch.from_numpy(x).to(BF16).requires_grad_(True)
    out = tfn(t)
    out.backward(torch.from_numpy(g).to(BF16))
    assert out.dtype == BF16
    np.testing.assert_array_equal(f32(out), f32(ref))
    rgrad = f32(vjp(gb)[0])
    np.testing.assert_allclose(f32(t.grad), rgrad, rtol=0, atol=GRAD_ATOL_REL * float(np.abs(rgrad).max()) if fn == "softmax" else 0)
    x32 = torch.from_numpy(x)
    torch.testing.assert_close(tfn(x32), {"sigmoid": torch.sigmoid, "silu": torch.nn.functional.silu, "softmax": lambda a: torch.softmax(a, -1)}[fn](x32), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K1 and K2: the plain bf16 versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

@pytest.fixture
def interpret():
    jrab._FORCE_INTERPRET[0] = True
    yield
    jrab._FORCE_INTERPRET[0] = False


@pytest.mark.parametrize("has_time", [True, False], ids=["time", "position_only"])
def test_rab_plain_bf16_matches_pallas_interpret(interpret, has_time):
    """L128, two heads, rows of one sequence padded; blocks of 32 so the kernels walk several tiles.  out, dq,
    dk, dv in bf16 equal to one bf16 ulp (a rounding of ``attn`` or of an f32 sum taken in another order may
    flip); dpos and dts in f32 to 1e-5 of their largest element (sums in another order)."""
    b, h, l, d, maxl = 2, 2, 128, 16, 160
    rng = np.random.default_rng(0)
    q, k, v, g = (rng.normal(size=(b, h, l, d)).astype(np.float32) for _ in range(4))
    pos_w = (rng.normal(size=(2 * maxl - 1, h)) * 0.3).astype(np.float32)
    ts_w = (rng.normal(size=(9, h)) * 0.3).astype(np.float32)
    ts = np.sort(rng.integers(0, 100_000, (b, l)), axis=1).astype(np.int32)
    mask = np.ones((b, l), bool)
    mask[1, :40] = False
    cfg, tcfg = jrab.BucketCfg(8, "sqrt", 1.0, "minutes"), trab.BucketCfg(8, "sqrt", 1.0, "minutes")

    def run(dtype):
        f = lambda qq, kk, vv, pw, tw: jrab.hstu_attention_rab(qq, kk, vv, pw, tw, jnp.asarray(ts) if has_time else None, jnp.asarray(mask), 0.25, maxl, cfg, 32, 32)  # noqa: E731
        out, vjp = jax.vjp(f, *(jnp.asarray(a, dtype) for a in (q, k, v)), jnp.asarray(pos_w), jnp.asarray(ts_w))
        return (out,) + vjp(jnp.asarray(g, dtype))

    j16, j32 = run(jnp.bfloat16), run(jnp.float32)
    tq, tk, tv, tg = (torch.from_numpy(a).to(BF16) for a in (q, k, v, g))
    targs = (torch.from_numpy(pos_w), torch.from_numpy(ts_w), torch.from_numpy(ts) if has_time else None, torch.from_numpy(mask), 0.25, maxl, tcfg, has_time)
    port = (trab.plain_forward_bf16(tq, tk, tv, *targs),) + trab.plain_backward_bf16(tq, tk, tv, tg, *targs)
    for name, p, r16, r32 in zip(("out", "dq", "dk", "dv", "dpos", "dts"), port, j16, j32):
        assert p.dtype == (BF16 if name in ("out", "dq", "dk", "dv") else torch.float32), name
        assert r16.dtype == (jnp.bfloat16 if name in ("out", "dq", "dk", "dv") else jnp.float32), name
        if not has_time and name == "dts":
            assert not p.any()
            continue
        scale = float(np.abs(f32(r16)).max())
        atol = scale * (2**-7 if p.dtype == BF16 else 1e-5)
        assert_bf16_like_jax(p, r16, r32, 0, atol, name)
    # the CPU path of the op and of the three backward wrappers takes these plain versions
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv, targs[0], targs[1])]
    out = trab.hstu_attention_rab(*leaves, *targs[2:7])
    out.backward(tg)
    np.testing.assert_array_equal(f32(out), f32(port[0]))
    for leaf, ref in zip(leaves, port[1:]):
        np.testing.assert_array_equal(f32(leaf.grad), f32(ref))
    args = (tq, tk, tv, tg) + targs[:7]
    assert all(torch.equal(a, r) for a, r in zip(trab.rab_backward_fused(*args), port[1:]))
    assert all(torch.equal(a, r) for a, r in zip(trab.rab_backward_dq(*args) + trab.rab_backward_dkv(*args), (port[1], port[4], port[5], port[2], port[3])))


# ---------------------------------------------------------------------------
# HSTU through SeqTrainer: one chunked step and evaluate
# ---------------------------------------------------------------------------

def hstu_data(n=4, seed=0):
    """Sequences of L, 100, 60 and 5 items (PAD after), sorted stamps, targets."""
    rng = np.random.default_rng(seed)
    toks = np.zeros((n, HSTU_L), np.int32)
    for i, length in enumerate([HSTU_L, 100, 60, 5][:n]):
        toks[i, :length] = rng.integers(1, HSTU_VOCAB, length)
    tds = np.sort(rng.integers(0, 10**6, (n, HSTU_L)), axis=1).astype(np.int32)
    return toks, np.tile(np.arange(HSTU_L, dtype=np.int32), (n, 1)), rng.integers(1, HSTU_VOCAB, n).astype(np.int32), tds


@functools.lru_cache(maxsize=None)
def hstu_jax():
    toks, _, tgts, tds = hstu_data()
    jmodel = JHSTUModel(**HSTU_KW)
    params = np_tree(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(toks[:1]), jnp.asarray(tds[:1]))["params"])

    def jloss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(toks), jnp.asarray(tds), training=True, return_hidden=True)
        return jce.chunked_next_token_loss(out["hidden"], out["weight"], jnp.asarray(toks), jnp.asarray(tgts), out["bias"], 1.0, 0, HSTU_CHUNK), out["hidden"]

    jrab._FORCE_INTERPRET[0] = True
    try:
        return params, jax_grads(jloss, params)
    finally:
        jrab._FORCE_INTERPRET[0] = False


def test_hstu_bf16_chunked_step_matches_jax():
    """The loss and the hidden states (bf16) to the bit or one ulp; the gradients as the module docstring says."""
    params, ref = hstu_jax()
    toks, pos, tgts, tds = hstu_data()
    model = load_flax_params(HSTUModel(**HSTU_KW), params)
    trainer = SeqTrainer(model, vocab_chunk_size=HSTU_CHUNK, precision="bf16", device="cpu")
    model.train()
    batch = [torch.from_numpy(a) for a in (toks, tds, tgts)]

    def loss_fn():
        out = model(batch[0], batch[1], return_hidden=True)
        assert out["hidden"].dtype == BF16 and out["weight"].dtype == torch.float32
        return trainer.loss_fn(*batch), out["hidden"]

    loss, hidden = port_step(model, loss_fn)
    assert loss.dtype == torch.float32
    assert_bf16_like_jax(loss, ref["bf16"][0], ref["f32"][0], 1e-6, 1e-6, "loss")
    assert_bf16_like_jax(hidden, ref["bf16"][1], ref["f32"][1], 0, 2**-7, "hidden")
    # a softmax over keys is blind to a bias added to every key: W_K.bias's exact gradient is 0 (noise, not compared)
    key_biases = {name for name, _ in model.named_parameters() if name.endswith("W_K.bias")}
    assert_grads_like_jax(dict(model.named_parameters()), ref["bf16"][2], ref["f32"][2], key_biases)
    trainer.train_one_epoch(tdata.SeqLoader(toks, pos, tgts, tds, batch_size=4), log_interval=0)
    assert_f32_state(trainer)
    assert tprec.precision() == "float32"


def test_hstu_bf16_evaluate_matches_jax():
    """``evaluate`` (the chunked loss and the top-1 of the last position) and ``predict_logits`` under bf16,
    against the JAX package's functions run as its eval step runs them (eval mode, the chunked CE, the chunked
    last-position logits with the PAD column at -1e9).  JAX's ops run eagerly here: under ``jit``, XLA's CPU
    fusions may keep an f32 intermediate unrounded, which moves its bf16 loss by about a third of the bf16-f32
    gap."""
    params, _ = hstu_jax()
    toks, pos, tgts, tds = hstu_data()
    jmodel = JHSTUModel(**HSTU_KW)
    ref = {}
    jrab._FORCE_INTERPRET[0] = True
    try:
        for prec in ("bf16", "f32"):
            with jscope(prec):
                out = jmodel.apply({"params": params}, jnp.asarray(toks), jnp.asarray(tds), training=False, return_hidden=True)
                loss = jce.chunked_next_token_loss(out["hidden"], out["weight"], jnp.asarray(toks), jnp.asarray(tgts), out["bias"], 1.0, 0, HSTU_CHUNK)
                last = jce.chunked_last_logits(out["hidden"][:, -1, :], out["weight"], out["bias"], 1.0).at[:, 0].set(-1e9)
                logits = jmodel.apply({"params": params}, jnp.asarray(toks), jnp.asarray(tds), training=False)[:, -1, :]
            ref[prec] = (float(loss), float(np.mean(np.asarray(jnp.argmax(last, axis=-1)) == tgts)), logits)
    finally:
        jrab._FORCE_INTERPRET[0] = False
    trainer = SeqTrainer(load_flax_params(HSTUModel(**HSTU_KW), params), vocab_chunk_size=HSTU_CHUNK, precision="bf16", device="cpu")
    loader = tdata.SeqLoader(toks, pos, tgts, tds, batch_size=4)
    loss, acc = trainer.evaluate(loader)
    logits = trainer.predict_logits(loader)
    assert logits.dtype == np.float32
    assert acc == ref["bf16"][1]
    assert_bf16_like_jax(np.float32(loss), np.float32(ref["bf16"][0]), np.float32(ref["f32"][0]), 1e-6, 1e-6, "evaluate loss")
    assert_bf16_like_jax(logits, ref["bf16"][2], ref["f32"][2], 0, 2**-7 * float(np.abs(f32(ref["bf16"][2])).max()), "predict_logits")
