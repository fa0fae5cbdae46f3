"""One ``CTRTrainer`` step of the port's Criteo-shaped ranking zoo against the
JAX package's from the same weights and Adam (loss, gradients, every
parameter after the step, the BatchNorm statistics), at the sizes of
``tests/test_e2e_ranking.py`` with dropout 0 (``test_torch_ranking_models.py``
has the forward checks and the step's details); and one sparse Adagrad step
of DCN with every table fused, against the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ctr_model import np_tree
from test_torch_cuda_ranking import LOSS_ATOL, LOSS_RTOL, build, check_step, ctr_frame
from test_torch_ranking_models import OPT, ZOO, check_train_step, jax_batch
from test_torch_sparse_train import TABLE_ATOL, TABLE_RTOL
from torch_rechub_tpu.basic import features as jfeat
from torch_rechub_tpu.basic.loss import bce_with_logits as jbce
from torch_rechub_tpu.models import ranking as jranking
from torch_rechub_tpu.ops import embedding as jemb
from torch_rechub_tpu.trainers.ctr_trainer import CTRTrainer as JCTRTrainer
from torch_rechub_tpu.utils import data as jdata
from torch_rechub_tpu_torch.basic import features as tfeat
from torch_rechub_tpu_torch.models import ranking as tranking
from torch_rechub_tpu_torch.ops import embedding as temb
from torch_rechub_tpu_torch.trainers import CTRTrainer
from torch_rechub_tpu_torch.utils import data as tdata
from torch_rechub_tpu_torch.utils.jax_weights import flax_to_state_dict, load_flax_params


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name", ZOO)
def test_zoo_train_step_matches_jax(tmp_path, name):
    check_train_step(tmp_path, name)


@pytest.fixture
def all_fused():
    old = (jemb.set_fused_default(True), temb.set_fused_default(True))
    yield
    jemb.set_fused_default(old[0])
    temb.set_fused_default(old[1])


def test_sparse_dcn_step_matches_jax(tmp_path, all_fused):
    """One ``sparse_embedding="adagrad"`` step of DCN with its five tables fused: the gather hook serves a
    second model.  The loss, the dense parameters after Adam, the fused table and its accumulator."""
    jtrainer = JCTRTrainer(build(jranking, jfeat, "DCN"), optimizer_params=OPT, model_path=str(tmp_path / "jax"), sparse_embedding="adagrad")
    x, y = ctr_frame(50, seed=1)
    jtrainer._ensure_ready(jdata.ArrayLoader(x, y, batch_size=64))
    params0, stats0 = np_tree(jtrainer.state.params), np_tree(jtrainer.state.batch_stats)
    model = load_flax_params(build(tranking, tfeat, "DCN"), params0, stats0)
    trainer = CTRTrainer(model, optimizer_params=OPT, model_path=str(tmp_path / "torch"), sparse_embedding="adagrad", device="cpu")
    (table_name,) = trainer.sparse_tables
    assert table_name == "EmbeddingCollection_0.fused_d8_table"

    xp, yp, w = jdata.pad_batch(x, y, 64)

    def jloss(p):
        out, _ = jtrainer.model.apply({"params": p, "batch_stats": stats0}, jax_batch(xp), training=True, mutable=["batch_stats"])
        return jbce(out, jnp.asarray(yp), jnp.asarray(w))

    jgrads = flax_to_state_dict(np_tree(jax.jit(jax.grad(jloss))(params0)))
    jstep_loss = jtrainer.train_one_epoch(jdata.ArrayLoader(x, y, batch_size=64), log_interval=0)
    loss = trainer.train_one_epoch(tdata.ArrayLoader(x, y, batch_size=64), log_interval=0)
    np.testing.assert_allclose(loss, jstep_loss, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    before, after = flax_to_state_dict(params0), flax_to_state_dict(np_tree(jtrainer.state.params))
    table = trainer.sparse_tables[table_name]
    assert table.grad is None
    rest = {k: p for k, p in trainer.model.named_parameters() if k != table_name}
    check_step({k: p.grad.numpy() for k, p in rest.items()}, {k: p.detach().numpy() for k, p in rest.items()},
               {k: jgrads[k].numpy() for k in rest}, {k: after[k].numpy() for k in rest}, {k: before[k].numpy() for k in rest}, 64, ref_grad_noise=True)
    np.testing.assert_allclose(table.detach().numpy(), after[table_name].numpy(), rtol=TABLE_RTOL, atol=TABLE_ATOL)
    moved = (table.detach() != before[table_name]).any(1)
    assert 0 < int(moved.sum()) <= 5 * 50  # the batch's rows, no other
    jaccum = flax_to_state_dict(np_tree(jtrainer.state.opt_state[1]))[table_name].numpy()
    np.testing.assert_allclose(trainer.sparse_accums[table_name].numpy(), jaccum, rtol=TABLE_RTOL, atol=TABLE_ATOL * float(jaccum.max()))
