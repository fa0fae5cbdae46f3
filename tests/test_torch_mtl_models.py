"""The port's multi-task models (SharedBottom, ESMM, MMOE, PLE with its CGC levels, AITM with its
AttentionLayer) against the JAX package's on carried weights, at the sizes of
``tests/test_e2e_multitask.py`` with dropout 0.

For each configuration: eval and train outputs (the ``(B, n_task)``
probabilities) within rtol 1e-5 / atol 1e-6, and the BatchNorm statistics the
train forward leaves within the same; the embedding tables are redrawn at
N(0, 0.3²) and the running statistics moved off their start, so the outputs
are not a fresh model's near-constant ones.  The port keeps flax's names
(``towers_{i}``, ``experts_{i}``, ``gates_{i}``, ``cgc_layers_{i}/experts_specific_{i}``,
``gate_shared``, ``aits_{i}/q_layer``), so the weights load strictly by name.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ctr_model import np_tree
from test_torch_cuda_mtl import BATCH, OUT_ATOL, OUT_RTOL, build_mtl, mtl_frame, task_types_of
from test_torch_cuda_ranking import STATS_ATOL, STATS_RTOL
from test_torch_ranking_models import jax_batch, redrawn
from torch_rechub_tpu.basic import features as jfeat
from torch_rechub_tpu.models import multi_task as jmt
from torch_rechub_tpu_torch.basic import features as tfeat
from torch_rechub_tpu_torch.models import multi_task as tmt
from torch_rechub_tpu_torch.utils.jax_weights import flax_to_state_dict, load_flax_params

CONFIGS = ("SharedBottom", "ESMM", "ESMM:dense", "MMOE", "PLE", "PLE:one_level", "AITM")


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def carried(name, seed=0):
    """A flax model of the configuration, its redrawn variables, and the port's model carrying them."""
    jmodel = build_mtl(jmt, jfeat, name)
    x, _ = mtl_frame(8)
    init = jax.jit(lambda rng, batch: jmodel.init(rng, batch, training=False))
    variables = redrawn(np_tree(init(jax.random.PRNGKey(seed), jax_batch(x))), seed)
    return jmodel, variables, load_flax_params(build_mtl(tmt, tfeat, name), variables["params"], variables["batch_stats"])


@pytest.mark.parametrize("name", CONFIGS)
def test_mtl_model_matches_jax(name):
    jmodel, variables, model = carried(name)
    x, _ = mtl_frame(BATCH, seed=7)
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    both = jax.jit(lambda v, batch: (jmodel.apply(v, batch, training=False), jmodel.apply(v, batch, training=True, mutable=["batch_stats"])))
    ref_eval, (ref_train, mutated) = both(variables, jax_batch(x))
    for ref, got in ((ref_eval, model.eval()(tx)), (ref_train, model.train()(tx))):
        assert got.shape == (BATCH, len(task_types_of(name)))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=OUT_RTOL, atol=OUT_ATOL)
    assert float(np.std(np.asarray(ref_eval))) > 0.01  # the redrawn tables reach the outputs
    ref_stats = flax_to_state_dict(np_tree(mutated["batch_stats"]))
    stats = dict(model.named_buffers())
    assert set(stats) == set(ref_stats)
    for key, b in stats.items():
        np.testing.assert_allclose(b.numpy(), ref_stats[key].numpy(), rtol=STATS_RTOL, atol=STATS_ATOL, err_msg=key)
    if name == "PLE:one_level":
        assert not hasattr(model.cgc_layers_0, "gate_shared")  # the last level has no shared gate
    if name == "PLE":
        assert hasattr(model.cgc_layers_0, "gate_shared") and not hasattr(model.cgc_layers_1, "gate_shared")


def test_attention_layer_matches_jax():
    """AITM's two-token attention: Dense layers without bias (torch's fan-in init), softmax over the tokens."""
    layer = jmt.aitm.AttentionLayer(dim=6)
    x = np.random.default_rng(0).normal(size=(5, 2, 6)).astype(np.float32)
    params = np_tree(layer.init(jax.random.PRNGKey(1), jnp.asarray(x)))["params"]
    assert set(params) == {"q_layer", "k_layer", "v_layer"} and set(params["q_layer"]) == {"kernel"}
    port = load_flax_params(tmt.AttentionLayer(6), params)
    ref = np.asarray(layer.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(), ref, rtol=OUT_RTOL, atol=OUT_ATOL)
    bound = 1 / np.sqrt(6)  # torch's fan-in init in both packages
    w = tmt.AttentionLayer(6, generator=torch.Generator().manual_seed(0)).q_layer.weight
    assert 0.5 * bound < float(w.detach().abs().max()) <= bound
