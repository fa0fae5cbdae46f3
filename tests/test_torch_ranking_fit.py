"""The port's mirrors of the JAX package's end-to-end ranking tests, on the CPU:
``tests/test_e2e_ranking.py::test_ranking_fit_evaluate`` for its 11
configurations (dropout 0.2) and ``tests/test_e2e_sequence_ranking.py``'s
DIN, BST and DIEN runs and its all-PAD DIEN row: synthetic data, ``fit`` for
one epoch, a sane AUC and probabilities.
"""

import numpy as np
import pytest
import torch

from test_e2e_sequence_ranking import EMBED, N_ITEMS, SEQ_LEN, seq_data
from test_torch_cuda_ranking import CTR_MODELS, build, ctr_frame, seq_schema
from torch_rechub_tpu_torch.basic import features as tfeat
from torch_rechub_tpu_torch.models import ranking as tranking
from torch_rechub_tpu_torch.trainers import CTRTrainer
from torch_rechub_tpu_torch.utils import data as tdata
from torch_rechub_tpu_torch.utils.data import ArrayLoader


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# tests/test_e2e_ranking.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CTR_MODELS)
def test_ranking_fit_evaluate(tmp_path, name):
    """The port's mirror of tests/test_e2e_ranking.py::test_ranking_fit_evaluate, dropout 0.2."""
    x, y = ctr_frame(300)
    train_dl, val_dl, test_dl = tdata.DataGenerator(x, y).generate_dataloader(split_ratio=[0.7, 0.15], batch_size=64)
    model = build(tranking, tfeat, name, dropout=0.2, generator=torch.Generator().manual_seed(0))
    trainer = CTRTrainer(model, n_epoch=1, model_path=str(tmp_path), device="cpu")
    trainer.fit(train_dl, val_dl)
    auc = trainer.evaluate(model, test_dl)
    assert 0.0 <= auc <= 1.0
    preds = trainer.predict(model, test_dl)
    assert preds.shape == (test_dl.dataset_size,) and np.all((preds >= 0) & (preds <= 1))


# ---------------------------------------------------------------------------
# tests/test_e2e_sequence_ranking.py
# ---------------------------------------------------------------------------

def run_trainer(tmp_path, model, x, y, loss_mode=True):
    dl = ArrayLoader(x, y, batch_size=64, shuffle=True)
    val = ArrayLoader(x, y, batch_size=64)
    trainer = CTRTrainer(model, n_epoch=1, model_path=str(tmp_path), loss_mode=loss_mode, device="cpu")
    trainer.fit(dl, val)
    auc = trainer.evaluate(model, val)
    assert 0.0 <= auc <= 1.0
    return trainer


def features():
    profile, history, neg, target = seq_schema(tfeat)
    return profile, history, neg, target


def test_din_e2e(tmp_path):
    x, y = seq_data()
    profile, history, _, target = features()
    model = tranking.DIN(features=profile, history_features=history, target_features=target, mlp_params={"dims": (16, 8)}, attention_mlp_params={"dims": (8,)}, generator=torch.Generator().manual_seed(0))
    run_trainer(tmp_path, model, x, y)


def test_bst_e2e(tmp_path):
    x, y = seq_data()
    profile, history, _, target = features()
    model = tranking.BST(features=profile, history_features=history, target_features=target, mlp_params={"dims": (16,)}, nhead=2, num_layers=1, max_seq_len=SEQ_LEN + 1, dim_feedforward=32,
                         generator=torch.Generator().manual_seed(0))
    run_trainer(tmp_path, model, x, y)


def test_dien_e2e(tmp_path):
    x, y = seq_data(with_neg=True)
    profile, history, neg, target = features()
    model = tranking.DIEN(features=profile, history_features=history, neg_history_features=neg, target_features=target, mlp_params={"dims": (16,)}, alpha=0.2, generator=torch.Generator().manual_seed(0))
    run_trainer(tmp_path, model, x, y, loss_mode=False)


def test_dien_all_padding_row_finite():
    """The port's mirror of test_dien_all_padding_row_finite: a train-mode forward on an all-PAD history."""
    x, _ = seq_data(n=8, with_neg=True)
    x["hist_item"][0] = 0
    x["neg_hist_item"][0] = 0
    profile, history, neg, target = features()
    model = tranking.DIEN(features=profile, history_features=history, neg_history_features=neg, target_features=target, mlp_params={"dims": (8,)}, generator=torch.Generator().manual_seed(0))
    logits, aux = model.train()({k: torch.from_numpy(v) for k, v in x.items()})
    assert torch.isfinite(logits).all() and torch.isfinite(aux)
    assert (N_ITEMS, EMBED) == tuple(model.EmbeddingCollection_0.target_item_table.shape)
