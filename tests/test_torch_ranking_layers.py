"""The port's ranking layers (``basic/layers.py``: CIN, the cross networks,
SENet, the bilinear interaction, the interacting layer, FFM, CEN; DIN's
``ActivationUnit``, DIEN's ``AUGRU``), the masked GRU (``ops/rnn.py``) and
the flax-rule initializers (``basic/initializers.py``) against the JAX
package: each layer's forward and the gradient of its float inputs on
carried parameters, and the initializers' moments on large draws.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import initializers as finit

from test_torch_ctr_model import np_tree
from test_torch_cuda_ranking import LOGIT_ATOL, LOGIT_RTOL
from torch_rechub_tpu.basic import layers as jlayers
from torch_rechub_tpu.models.ranking.dien import AUGRU as JAUGRU
from torch_rechub_tpu.models.ranking.dien import _auxiliary_loss as jaux_loss
from torch_rechub_tpu.models.ranking.din import ActivationUnit as JActivationUnit
from torch_rechub_tpu.ops.rnn import GRULayer as JGRULayer
from torch_rechub_tpu_torch.basic import initializers as tinit
from torch_rechub_tpu_torch.basic import layers as tlayers
from torch_rechub_tpu_torch.models.ranking.dien import AUGRU, _auxiliary_loss
from torch_rechub_tpu_torch.models.ranking.din import ActivationUnit
from torch_rechub_tpu_torch.ops.rnn import GRULayer
from torch_rechub_tpu_torch.utils.jax_weights import flax_to_state_dict, load_flax_params

# input gradients: fp32 backward of the same products in another order; the absolute part is
# relative to the largest element, since sums that cancel sit near zero
GRAD_RTOL, GRAD_ATOL_REL = 1e-5, 1e-6
B, F, D = 16, 5, 8


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def seq_mask(rng, b, l):
    """Post-padded validity of ``(b, l)``: lengths 1..l, the first row all PAD, the second full."""
    lengths = rng.integers(1, l + 1, b)
    lengths[0], lengths[1] = 0, l
    return (np.arange(l)[None, :] < lengths[:, None]).astype(np.float32)


def layer_case(name, rng):
    """``(flax module, port module, inputs, how many leading inputs take a gradient, flax call kwargs)``."""
    x2, x3 = normal(rng, B, F * D), normal(rng, B, F, D)
    cases = {
        "CIN_split_half": lambda: (jlayers.CIN(input_dim=F, cin_size=(4, 6)), tlayers.CIN(F, (4, 6)), [x3]),
        "CIN_whole": lambda: (jlayers.CIN(input_dim=F, cin_size=(3, 5), split_half=False), tlayers.CIN(F, (3, 5), split_half=False), [x3]),
        "CrossLayer": lambda: (jlayers.CrossLayer(), tlayers.CrossLayer(F * D), [x2, normal(rng, B, F * D)]),
        "CrossNetwork": lambda: (jlayers.CrossNetwork(3), tlayers.CrossNetwork(F * D, 3), [x2]),
        "CrossNetV2": lambda: (jlayers.CrossNetV2(3), tlayers.CrossNetV2(F * D, 3), [x2]),
        "CrossNetMix": lambda: (jlayers.CrossNetMix(num_layers=2, low_rank=3, num_experts=3), tlayers.CrossNetMix(F * D, 2, 3, 3), [x2]),
        "SENETLayer": lambda: (jlayers.SENETLayer(F, 2), tlayers.SENETLayer(F, 2), [x3]),
        "BiLinear_field_all": lambda: (jlayers.BiLinearInteractionLayer(F, "field_all"), tlayers.BiLinearInteractionLayer(D, F, "field_all"), [x3]),
        "BiLinear_field_each": lambda: (jlayers.BiLinearInteractionLayer(F, "field_each"), tlayers.BiLinearInteractionLayer(D, F, "field_each"), [x3]),
        "BiLinear_field_interaction": lambda: (jlayers.BiLinearInteractionLayer(F), tlayers.BiLinearInteractionLayer(D, F), [x3]),
        "InteractingLayer": lambda: (jlayers.InteractingLayer(D, num_heads=2), tlayers.InteractingLayer(D, 2), [x3]),
        "InteractingLayer_no_residual": lambda: (jlayers.InteractingLayer(D, num_heads=4, residual=False), tlayers.InteractingLayer(D, 4, residual=False), [x3]),
        "FFM": lambda: (jlayers.FFM(F), tlayers.FFM(F), [normal(rng, B, F, F, D)]),
        "FFM_crosses": lambda: (jlayers.FFM(F, reduce_sum=False), tlayers.FFM(F, reduce_sum=False), [normal(rng, B, F, F, D)]),
        "CEN": lambda: (jlayers.CEN(D, 10, 2), tlayers.CEN(D, 10, 2), [normal(rng, B, 10, D)]),
        "ActivationUnit": lambda: (JActivationUnit(D, dims=(6,)), ActivationUnit(D, (6,)), [normal(rng, B, 7, D), normal(rng, B, D)]),
        "AUGRU": lambda: (JAUGRU(D), AUGRU(D), [normal(rng, B, 7, D), normal(rng, B, D), seq_mask(rng, B, 7)]),
    }
    jmod, tmod, inputs = cases[name]()
    n_grad = 2 if name in ("CrossLayer", "ActivationUnit", "AUGRU") else 1
    return jmod, tmod, inputs, n_grad, {"training": False} if name in ("CEN", "ActivationUnit") else {}


LAYERS = ("CIN_split_half", "CIN_whole", "CrossLayer", "CrossNetwork", "CrossNetV2", "CrossNetMix", "SENETLayer", "BiLinear_field_all", "BiLinear_field_each",
          "BiLinear_field_interaction", "InteractingLayer", "InteractingLayer_no_residual", "FFM", "FFM_crosses", "CEN", "ActivationUnit", "AUGRU")


@pytest.mark.parametrize("name", LAYERS)
def test_layer_matches_jax(name):
    """The forward and the gradient of a random cotangent with respect to the float inputs, on carried parameters."""
    rng = np.random.default_rng(sum(map(ord, name)))
    jmod, tmod, inputs, n_grad, jkw = layer_case(name, rng)
    jx = [jnp.asarray(a) for a in inputs]
    variables = np_tree(jax.jit(lambda rng, *xs: jmod.init(rng, *xs, **jkw))(jax.random.PRNGKey(0), *jx))  # one compile, not one per op
    load_flax_params(tmod, variables.get("params", {}), variables.get("batch_stats"))
    ref = np.asarray(jax.jit(lambda *xs: jmod.apply(variables, *xs, **jkw))(*jx))
    cot = normal(rng, *ref.shape)

    def jfn(*grad_args):
        return jnp.sum(jmod.apply(variables, *grad_args, *jx[n_grad:], **jkw) * cot)

    ref_grads = jax.jit(jax.grad(jfn, argnums=tuple(range(n_grad))))(*jx[:n_grad])
    tx = [torch.tensor(a, requires_grad=i < n_grad) for i, a in enumerate(inputs)]
    out = tmod.eval()(*tx)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    (out * torch.from_numpy(cot)).sum().backward()
    for t, r in zip(tx[:n_grad], ref_grads, strict=True):
        r = np.asarray(r)
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=GRAD_RTOL, atol=GRAD_ATOL_REL * float(np.abs(r).max()))
    assert {n for n, _ in tmod.named_parameters()} == set(flax_to_state_dict(variables.get("params", {})))


def test_pair_layers_raise_on_what_they_cannot_build():
    with pytest.raises(NotImplementedError):
        tlayers.BiLinearInteractionLayer(D, F, "field_pairs")
    with pytest.raises(ValueError, match="halves"):
        tlayers.CIN(F, (3, 4))
    with pytest.raises(ValueError, match="divisible"):
        tlayers.InteractingLayer(D, 3)


def test_augru_and_aux_loss_on_all_pad_rows():
    """AUGRU's all-PAD row: uniform attention (-1e9, not -inf), a zero final state, finite gradients;
    the auxiliary loss divides by max(Σvalid, 1), so an all-PAD batch gives 0."""
    rng = np.random.default_rng(3)
    seq, item, mask = normal(rng, 4, 6, D), normal(rng, 4, D), seq_mask(rng, 4, 6)
    mask[2] = 0.0
    augru = AUGRU(D, generator=torch.Generator().manual_seed(0))
    s = torch.tensor(seq, requires_grad=True)
    h = augru(s, torch.from_numpy(item), torch.from_numpy(mask))
    assert torch.equal(h[0], torch.zeros(D)) and torch.equal(h[2], torch.zeros(D)) and h[1].abs().sum() > 0
    h.sum().backward()
    assert torch.isfinite(s.grad).all() and not s.grad[0].any()
    pos, neg = normal(rng, 4, 6, D), normal(rng, 4, 6, D)
    for m in (mask, np.zeros_like(mask)):
        ref = float(jaux_loss(jnp.asarray(seq), jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(m)))
        got = float(_auxiliary_loss(*(torch.from_numpy(a) for a in (seq, pos, neg, m))))
        np.testing.assert_allclose(got, ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    assert got == 0.0


# ---------------------------------------------------------------------------
# the masked GRU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked,use_bias", [(True, True), (False, True), (True, False)], ids=["masked", "unmasked", "masked_no_bias"])
def test_gru_matches_jax(masked, use_bias):
    """Outputs, final state and the input gradient against ``ops/rnn.py:GRULayer``; under a mask the state
    freezes at PAD steps (the final state is the last valid step's output) and the outputs there are 0."""
    rng = np.random.default_rng(4)
    seq, mask = normal(rng, 9, 7, 5), seq_mask(rng, 9, 7)
    jgru = JGRULayer(6, use_bias=use_bias)
    jargs = (jnp.asarray(seq), jnp.asarray(mask) if masked else None)
    params = np_tree(jgru.init(jax.random.PRNGKey(1), *jargs)["params"])
    gru = load_flax_params(GRULayer(5, 6, use_bias=use_bias), params)
    assert gru.w_i.shape == (5, 18) and gru.w_h.shape == (6, 18)
    ref_out, ref_h = (np.asarray(a) for a in jgru.apply({"params": params}, *jargs))
    s = torch.tensor(seq, requires_grad=True)
    out, h = gru(s, torch.from_numpy(mask) if masked else None)
    np.testing.assert_allclose(out.detach().numpy(), ref_out, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    np.testing.assert_allclose(h.detach().numpy(), ref_h, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    cot_out, cot_h = normal(rng, *ref_out.shape), normal(rng, *ref_h.shape)

    def jfn(sq):
        o, hh = jgru.apply({"params": params}, sq, *jargs[1:])
        return jnp.sum(o * cot_out) + jnp.sum(hh * cot_h)

    ref_grad = np.asarray(jax.grad(jfn)(jargs[0]))
    ((out * torch.from_numpy(cot_out)).sum() + (h * torch.from_numpy(cot_h)).sum()).backward()
    np.testing.assert_allclose(s.grad.numpy(), ref_grad, rtol=GRAD_RTOL, atol=GRAD_ATOL_REL * float(np.abs(ref_grad).max()))
    if masked:
        valid = mask > 0
        assert not out.detach().numpy()[~valid].any()
        last = valid.sum(1) - 1
        np.testing.assert_array_equal(h.detach().numpy()[1:], out.detach().numpy()[np.arange(1, 9), last[1:]])
        assert not h[0].any()  # the all-PAD row never leaves the zero state
    else:
        np.testing.assert_array_equal(h.detach().numpy(), out.detach().numpy()[:, -1])


# ---------------------------------------------------------------------------
# initializers: flax's fans
# ---------------------------------------------------------------------------

# (port initializer, flax initializer, shape, the fan of the variance, or None for U[0, 1) / N(0, 1))
INITS = {
    "torch_linear_init_conv_w": (tinit.torch_linear_init, jlayers.torch_linear_init, (64, 1600), 64),  # CIN's (size, C): the fan is axis 0
    "torch_linear_init_gate_w": (tinit.torch_linear_init, jlayers.torch_linear_init, (4, 16384), 4),  # CrossNetMix's (E, d)
    "torch_linear_init_bilinear": (tinit.torch_linear_init, jlayers.torch_linear_init, (325, 16, 16), 16 * 325),  # (P, d, d): d·P
    "xavier_uniform_3d": (tinit.xavier_uniform, finit.xavier_uniform(), (4, 416, 32), (416 * 4 + 32 * 4) / 2),
    "xavier_normal_3d": (tinit.xavier_normal, finit.xavier_normal(), (64, 32, 32), (32 * 64 + 32 * 64) / 2),
    "xavier_uniform_2d": (tinit.xavier_uniform, finit.xavier_uniform(), (256, 256), 256),
    "uniform_1": (tinit.uniform(1.0), finit.uniform(1.0), (2000, 32), None),
    "normal_1": (tinit.normal(1.0), finit.normal(1.0), (2000, 32), None),
}
# moments of 50,000 draws or more: the standard error of a mean or std is below 0.5% of the std
MOMENT_TOL = 0.02


@pytest.mark.parametrize("name", INITS)
def test_initializers_follow_flax(name):
    tinit_fn, finit_fn, shape, fan = INITS[name]
    got = tinit_fn(shape, torch.Generator().manual_seed(0)).numpy()
    ref = np.asarray(finit_fn(jax.random.PRNGKey(0), shape, jnp.float32))
    assert got.shape == ref.shape == shape and got.dtype == np.float32
    for a in (got, ref):
        if fan is not None:  # variance 1/(3 fan) for torch_linear_init, 1/fan_avg for xavier
            expected = math.sqrt((1.0 / 3.0 if "torch_linear" in name else 1.0) / fan)
        else:
            expected = 1.0 / math.sqrt(12.0) if name.startswith("uniform") else 1.0
        assert abs(a.std() - expected) < MOMENT_TOL * expected, (a.std(), expected)
        assert abs(a.mean() - (0.5 if name.startswith("uniform") else 0.0)) < MOMENT_TOL * expected
    if name == "uniform_1":
        assert 0.0 <= got.min() and got.max() < 1.0
    elif "uniform" in name or "torch_linear" in name:  # U(-bound, bound), bound = sqrt(3) std; both reach it
        bound = math.sqrt(3.0) * expected
        for a in (got, ref):
            assert np.abs(a).max() <= bound * (1 + 1e-6) and np.abs(a).max() > 0.99 * bound
    if name == "xavier_normal_3d":  # truncated at two standard deviations of the untruncated law
        bound = 2 * math.sqrt(1.0 / fan) / 0.87962566103423978
        assert np.abs(got).max() <= bound * (1 + 1e-6) and np.abs(ref).max() <= bound * (1 + 1e-6)
    assert torch.equal(tinit.ones((3, 2)), torch.ones(3, 2))


def test_torch_xavier_takes_other_fans_on_3d():
    """torch.nn.init.xavier_* reads the fans of a 3-D tensor otherwise (fan_in = size(1)·receptive,
    receptive = the trailing dims): on CrossNetMix's (E, d, r) it draws at another scale than flax."""
    shape = (4, 416, 32)
    torch_std = torch.nn.init.xavier_uniform_(torch.empty(shape), generator=torch.Generator().manual_seed(0)).std().item()
    flax_std = tinit.xavier_uniform(shape, torch.Generator().manual_seed(0)).std().item()
    assert abs(flax_std - math.sqrt(2.0 / (416 * 4 + 32 * 4))) < MOMENT_TOL * flax_std
    assert abs(torch_std - math.sqrt(2.0 / (416 * 32 + 4 * 32))) < MOMENT_TOL * torch_std
    assert torch_std < 0.5 * flax_std
