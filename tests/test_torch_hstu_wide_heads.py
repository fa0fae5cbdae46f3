"""The port's HSTU at wide heads against the JAX package on the CPU.

``examples/generative/run_hstu.py`` sets ``dqk = dv = d_model // 4`` with 4
heads, so ``--d_model 1024`` is 4 heads of 256: wider than the tensor-core
kernels hold, which the card now serves through the width-tiled variants.
Here the port's plain path (two layers, L64) takes the same widths and
matches the JAX model on carried weights: its logits, and the gradients of
one loss with respect to every parameter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_hstu_model import MODEL_ATOL, MODEL_RTOL, seq_batch, to_numpy_tree
from torch_rechub_tpu.models.generative.hstu import HSTUModel as JHSTUModel
from torch_rechub_tpu_torch.models.generative.hstu import HSTUModel
from torch_rechub_tpu_torch.utils.jax_weights import load_flax_params

WIDE_KW = dict(vocab_size=64, d_model=1024, n_heads=4, n_layers=2, dqk=256, dv=256, dropout=0.0, num_time_buckets=8, max_seq_len=64)
# gradients: sums over 1024-wide rows and 4 x 64 pairs a head, in another order than XLA's; relative to the
# largest gradient of each parameter
GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 1e-4


@pytest.fixture(scope="module")
def carried():
    toks, tds = seq_batch(4, 64, seed=11)
    jmodel = JHSTUModel(**WIDE_KW)
    variables = jmodel.init(jax.random.PRNGKey(11), jnp.asarray(toks), jnp.asarray(tds), training=False)
    model = load_flax_params(HSTUModel(**WIDE_KW), to_numpy_tree(variables["params"])).eval()
    return jmodel, variables, model, toks, tds


def test_wide_head_hstu_logits_match_jax(carried):
    jmodel, variables, model, toks, tds = carried
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(toks), jnp.asarray(tds), training=False))
    with torch.no_grad():
        got = model(torch.from_numpy(toks), torch.from_numpy(tds)).numpy()
    np.testing.assert_allclose(got, ref, rtol=MODEL_RTOL, atol=MODEL_ATOL)


def test_wide_head_hstu_gradients_match_jax(carried):
    jmodel, variables, model, toks, tds = carried
    weights = np.random.default_rng(12).normal(size=(4, 64, 64)).astype(np.float32)

    def jloss(params):
        return jnp.sum(jmodel.apply({**variables, "params": params}, jnp.asarray(toks), jnp.asarray(tds), training=False) * weights)

    # the JAX gradients carried as if they were weights: the port's names and layouts
    ref = dict(load_flax_params(HSTUModel(**WIDE_KW), to_numpy_tree(jax.grad(jloss)(variables["params"]))).named_parameters())
    model.zero_grad()
    (model(torch.from_numpy(toks), torch.from_numpy(tds)) * torch.from_numpy(weights)).sum().backward()
    for name, p in model.named_parameters():
        want = ref[name].detach().numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=GRAD_RTOL, atol=GRAD_ATOL_REL * np.abs(want).max() + 1e-12, err_msg=name)
