"""The port's sequence ranking models (DIN, BST, DIEN) against the JAX package
on carried weights, at the sizes of ``tests/test_e2e_sequence_ranking.py``
(L10, 50 items), dropout 0, with all-PAD histories in every batch.

Eval and train logits, DIEN's aux loss, the BatchNorm statistics and one
``CTRTrainer`` step as ``test_torch_ranking_models.py`` checks them; BST's
attention carried from flax's ``DenseGeneral`` kernels; DIN's attention MLP
seeing the PAD positions, as in the reference; DIEN on all-PAD rows.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ctr_model import np_tree
from test_torch_cuda_ranking import LOGIT_ATOL, LOGIT_RTOL, SEQ_LEN, SEQ_MODELS, build, seq_frame
from test_torch_ranking_models import check_forward, check_train_step
from torch_rechub_tpu.basic.layers import torch_linear_init as jtorch_linear_init
from torch_rechub_tpu_torch.basic import features as tfeat
from torch_rechub_tpu_torch.basic.loss import bce_with_logits
from torch_rechub_tpu_torch.models import ranking as tranking
from torch_rechub_tpu_torch.models.ranking.bst import MultiHeadDotProductAttention
from torch_rechub_tpu_torch.utils.jax_weights import flax_to_state_dict, load_flax_params


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name", SEQ_MODELS)
def test_sequence_zoo_matches_jax(name):
    check_forward(name)


@pytest.mark.parametrize("name", SEQ_MODELS)
def test_sequence_zoo_train_step_matches_jax(tmp_path, name):
    check_train_step(tmp_path, name)


def test_bst_attention_carries_flax_dense_general():
    """flax's ``MultiHeadDotProductAttention`` keeps ``(in, heads, head_dim)`` query / key / value kernels with
    ``(heads, head_dim)`` biases and an ``(heads, head_dim, out)`` out kernel: the carrier flattens the heads
    (a plain ``.T`` would reverse all three axes), and the attention agrees under a key mask."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 9, 8)).astype(np.float32)
    attend = rng.uniform(size=(6, 1, 1, 9)) > 0.3
    attend[..., -1] = True  # every query keeps a key, as BST's target position does
    jmha = fnn.MultiHeadDotProductAttention(num_heads=2, kernel_init=jtorch_linear_init, deterministic=True)
    params = np_tree(jmha.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(x), mask=jnp.asarray(attend))["params"])
    params = jax.tree_util.tree_map(lambda a: (a + rng.normal(size=a.shape) * 0.1).astype(np.float32), params)  # biases off 0
    assert params["query"]["kernel"].shape == (8, 2, 4) and params["out"]["kernel"].shape == (2, 4, 8)
    state = flax_to_state_dict(params)
    np.testing.assert_array_equal(state["query.weight"].numpy(), params["query"]["kernel"].reshape(8, 8).T)
    np.testing.assert_array_equal(state["value.bias"].numpy(), params["value"]["bias"].reshape(8))
    np.testing.assert_array_equal(state["out.weight"].numpy(), params["out"]["kernel"].reshape(8, 8).T)
    mha = load_flax_params(MultiHeadDotProductAttention(8, 2), params).eval()
    ref = np.asarray(jmha.apply({"params": params}, jnp.asarray(x), jnp.asarray(x), mask=jnp.asarray(attend)))
    got = mha(torch.from_numpy(x), torch.from_numpy(attend)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


def test_carrier_raises_on_a_kernel_it_cannot_map():
    for tree in ({"Dense_0": {"kernel": np.zeros((2, 3, 4), np.float32)}}, {"query": {"kernel": np.zeros((2, 3, 4, 5), np.float32)}}, {"kernel": np.zeros((2, 3, 4), np.float32)}):
        with pytest.raises(ValueError, match="no mapping for a kernel"):
            flax_to_state_dict(tree)


def test_din_attention_mlp_sees_pad_positions():
    """As in the JAX package, the ActivationUnit's MLP runs on every position: its BatchNorm's batch mean in
    training counts the PAD positions of the history (zero embeddings, so ``[t, 0, t, 0]``)."""
    model = build(tranking, tfeat, "DIN", generator=torch.Generator().manual_seed(0)).train()
    x, _ = seq_frame(32, seed=4)
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    unit = model.ActivationUnit_0
    seen = []
    hook = unit.MLP_0.Dense_0.register_forward_hook(lambda mod, inp, out: seen.append(out.detach().reshape(-1, out.shape[-1])))
    model(tx)
    hook.remove()
    (dense_out,) = seen
    assert dense_out.shape[0] == 32 * SEQ_LEN  # every position, PAD ones included
    mean_all = dense_out.mean(0)
    np.testing.assert_allclose(unit.MLP_0.BatchNorm_0.mean.numpy(), 0.1 * mean_all.numpy(), rtol=1e-5, atol=1e-7)
    valid = torch.from_numpy(x["hist_item"].reshape(-1) != 0)
    assert not torch.allclose(dense_out[valid].mean(0), mean_all, rtol=1e-3)


def test_dien_all_padding_rows_finite_forward_and_backward():
    """All-PAD histories: finite logits and aux loss, finite gradients, and a zero AUGRU state for those rows."""
    model = build(tranking, tfeat, "DIEN", generator=torch.Generator().manual_seed(0)).train()
    x, y = seq_frame(16, seed=5, all_pad_rows=3)
    assert not x["hist_item"][:3].any()
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    logits, aux = model(tx)
    assert torch.isfinite(logits).all() and torch.isfinite(aux)
    (bce_with_logits(logits, torch.from_numpy(y)) + aux).backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    ec = model.EmbeddingCollection_0
    seq = ec(tx, model.history_features)[:, 0]
    mask = (tx["hist_item"] != 0).float()
    outs, _ = model.GRULayer_0(seq, mask)
    h = model.AUGRU_0(outs, ec(tx, model.target_features)[:, 0], mask)
    assert not h[:3].any() and h[3:].abs().sum(1).min() > 0
