"""The example scripts' own helpers against the JAX scripts': the synthetic data of the HSTU, HLLM,
Amazon-Electronics and Criteo-production scripts, ``run_ml_matching.build_model``'s parameters for every model
name, ``mtl_common``'s ESMM labels as the trainer receives them, and the HSTU example's masked top-k against
``jax.lax.top_k`` on the same logits."""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import datasets as jdatasets
from examples.generative import run_hllm as jhllm
from examples.generative import run_hstu as jhstu
from examples.matching import run_ml_matching as jmatching
from examples.ranking import mtl_common as jmtl
from examples.ranking import run_amazon_electronics as jamazon
from examples.ranking import run_criteo_production as jcriteo
from examples_torch import datasets as tdatasets
from examples_torch.generative import run_hllm as thllm
from examples_torch.generative import run_hstu as thstu
from examples_torch.matching import run_ml_matching as tmatching
from examples_torch.ranking import mtl_common as tmtl
from examples_torch.ranking import run_amazon_electronics as tamazon
from examples_torch.ranking import run_criteo_production as tcriteo
from test_torch_examples_helpers import assert_same, assert_same_parameters, seeded
from torch_rechub_tpu.utils.hstu_utils import apply_vocab_mask


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("kwargs", [{}, dict(n_users=37, vocab=50, seq_len=8, seed=3)], ids=["defaults", "small"])
def test_hstu_synthetic_sequences_match(kwargs):
    assert_same(thstu.synthetic_sequences(**kwargs), jhstu.synthetic_sequences(**kwargs), "run_hstu.synthetic_sequences")


@pytest.mark.parametrize("vocab,d_model,seq_len", [(128, 32, 24), (40, 8, 6)])
def test_hllm_synthetic_table_and_sequences_match(vocab, d_model, seq_len):
    assert_same(thllm.synthetic_item_embeddings(vocab, d_model), jhllm.synthetic_item_embeddings(vocab, d_model), "synthetic_item_embeddings")
    assert_same(thllm.synthetic_sequences(50, vocab, seq_len, seed=2), jhllm.synthetic_sequences(50, vocab, seq_len, seed=2), "synthetic_sequences")


def test_amazon_electronics_click_log_matches():
    import pandas as pd

    for kwargs in ({}, dict(n_users=30, n_items=40, n_cates=5, n_clicks=300, seed=1)):
        pd.testing.assert_frame_equal(tamazon.make_click_log(**kwargs), jamazon.make_click_log(**kwargs))


@pytest.mark.parametrize("scale,n,seed", [(0.001, 2048, 2022), (0.0003, 512, 7)])
def test_criteo_production_ids_and_labels_match(scale, n, seed, monkeypatch):
    """The JAX script's ids and labels, as its ``DeviceCachedLoader`` receives them (the trainer and the loader
    replaced by recorders), against ``synthetic_clicks``; the vocabs against the features it declares."""
    import torch_rechub_tpu.trainers as jtrainers
    import torch_rechub_tpu.utils.data as jdata

    seen = {}

    class Loader:
        def __init__(self, x, y, **kwargs):
            seen.update(x=x, y=y, kwargs=kwargs)

    class Trainer:
        def __init__(self, model, **kwargs):
            seen["vocabs"] = [f.vocab_size for f in model.fm_features]

        def train_one_epoch(self, loader, log_interval=0):
            return 0.0

        def evaluate(self, model, loader, bucketed=False):
            return 0.5

    monkeypatch.setattr(jdata, "DeviceCachedLoader", Loader)
    monkeypatch.setattr(jtrainers, "CTRTrainer", Trainer)
    monkeypatch.setattr(sys, "argv", ["x", "--scale", str(scale), "--n-examples", str(n), "--seed", str(seed)])
    jcriteo.main()
    vocabs, x, y = tcriteo.synthetic_clicks(scale, n, seed)
    assert vocabs == seen["vocabs"] and tcriteo.VOCABS_FULL == jcriteo.VOCABS_FULL
    assert_same((x, y), (seen["x"], seen["y"]), "criteo production data")
    assert seen["kwargs"] == dict(batch_size=4096, group_size=32, mesh=None)


def matching_batch(name, mode):
    """A batch of the JAX bundle the script builds for a model of ``mode`` (and YoutubeSBC's sample weight)."""
    bundle = seeded(jdatasets.build_ml1m_matching_dataset, mode=mode, neg_ratio=3, seq_max_len=20)
    x = {k: v[:8] for k, v in bundle.x_train.items()}
    if name == "youtube_sbc":
        x["sample_weight"] = np.ones(8, np.float32)
    return x


@pytest.mark.parametrize("name", tmatching.MODELS)
def test_ml_matching_build_model_gives_the_jax_parameters(name):
    """Every model name of ``run_ml_matching.py``: the same mode, and the JAX model's parameters by name and shape."""
    assert tmatching.MODELS == jmatching.MODELS
    jmodel, jmode = jmatching.build_model(name, 200, 300, 16, 20)
    model, mode = tmatching.build_model(name, 200, 300, 16, 20, generator=torch.Generator().manual_seed(0), device="cpu")
    assert mode == jmode
    assert_same_parameters(model, jmodel, matching_batch(name, mode))


@pytest.mark.parametrize("model_name", ["esmm", "mmoe"])
def test_mtl_common_hands_the_trainer_the_jax_labels(model_name, monkeypatch):
    """``fit_multitask`` on the census bundle, the trainer replaced by a recorder in both packages: the task types,
    the train and test labels (ESMM's ``[cvr, ctr, ctcvr]``) and the batch sizes are the same."""
    seen = {}

    def recorder(key):
        class Trainer:
            def __init__(self, model, task_types, **kwargs):
                seen[key] = {"task_types": tuple(task_types)}

            def fit(self, train, val):
                seen[key].update(y_train=train.y, y_test=val.y, batch=(train.batch_size, val.batch_size))
                return [[0.5]]
        return Trainer

    monkeypatch.setattr(jmtl, "MTLTrainer", recorder("jax"))
    monkeypatch.setattr(tmtl, "MTLTrainer", recorder("port"))
    args = types.SimpleNamespace(model_name=model_name, adaptive=None, epoch=1, learning_rate=1e-3, batch_size=64, seed=1, save_dir=".", device="cpu")
    jmtl.fit_multitask(jdatasets.build_census_multitask_dataset(), args)
    tmtl.fit_multitask(tdatasets.build_census_multitask_dataset(), args)
    assert_same(seen["port"], seen["jax"], "fit_multitask")
    assert seen["port"]["y_train"].shape[1] == (3 if model_name == "esmm" else 2)


@pytest.mark.parametrize("k", [1, 10])
def test_hstu_masked_topk_matches_jax(k):
    """PAD and each row's seen items masked, then the top k: ties (integer logits) in JAX's order."""
    rng = np.random.default_rng(k)
    logits = rng.integers(-3, 4, (12, 40)).astype(np.float32)
    seen = rng.integers(0, 40, (12, 9)).astype(np.int32)
    seen[:, -2:] = 0  # PAD in the history
    masked = apply_vocab_mask(jnp.asarray(logits), static_invalid=[0], invalid_ids=seen)
    np.testing.assert_array_equal(thstu.masked_topk(logits, seen, k), np.asarray(jax.lax.top_k(masked, k)[1]))
