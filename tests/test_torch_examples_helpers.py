"""The examples' helpers of the PyTorch port against the JAX package's: ``examples_torch/datasets.py`` against
``benchmarks/datasets.py`` array for array, ``examples_torch/models.py`` against ``benchmarks/models.py`` (every
registry name's parameters, by name and shape, carried through ``utils/jax_weights.py``), and
``examples_torch/metrics.py``'s ``evaluate_retrieval`` against ``benchmarks/metrics.py``'s on given embeddings."""

import dataclasses
import random

import jax
import numpy as np
import pytest
import torch

from benchmarks import datasets as jdatasets
from benchmarks import metrics as jmetrics
from benchmarks import models as jmodels
from examples_torch import datasets as tdatasets
from examples_torch import metrics as tmetrics
from examples_torch import models as tmodels
from torch_rechub_tpu_torch.utils.jax_weights import flax_to_state_dict, load_flax_params

# exact retrieval on the same embeddings: the metrics are means over the same lists; GAUC and the beyond-accuracy
# scores come from float32 scores computed in another order
METRIC_RTOL = 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def seeded(fn, *args, **kwargs):
    """``fn`` after seeding the global ``random`` and ``np.random`` streams, which the matching preprocessing
    (``generate_seq_feature_match``) shuffles and samples negatives with in both packages."""
    random.seed(0)
    np.random.seed(0)
    return fn(*args, **kwargs)


def feature_key(f):
    return (type(f).__name__, f.name, getattr(f, "vocab_size", None), f.embed_dim, getattr(f, "pooling", None), getattr(f, "shared_with", None), getattr(f, "padding_idx", None))


def assert_same(got, ref, where):
    if dataclasses.is_dataclass(ref) and not hasattr(ref, "embed_dim"):
        assert type(got).__name__ == type(ref).__name__, where
        for field in dataclasses.fields(ref):
            assert_same(getattr(got, field.name), getattr(ref, field.name), f"{where}.{field.name}")
    elif hasattr(ref, "embed_dim"):  # a feature
        assert feature_key(got) == feature_key(ref), where
    elif isinstance(ref, dict):
        assert list(got) == list(ref), where
        for k in ref:
            assert_same(got[k], ref[k], f"{where}[{k!r}]")
    elif isinstance(ref, (tuple, list)) and not isinstance(ref, np.ndarray):
        assert len(got) == len(ref), where
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_same(g, r, f"{where}[{i}]")
    else:
        got, ref = np.asarray(got), np.asarray(ref)
        assert got.dtype == ref.dtype, (where, got.dtype, ref.dtype)
        np.testing.assert_array_equal(got, ref, err_msg=where)


BUILDERS = sorted(name for name in dir(jdatasets) if name.startswith("build_") and name.endswith("_dataset"))


def test_the_port_has_every_builder_and_bundle():
    assert len(BUILDERS) == 9 and sorted(jdatasets.DATASETS) == sorted(tdatasets.DATASETS)
    for name in BUILDERS + ["RankingDatasetBundle", "MatchingDatasetBundle", "MultiTaskDatasetBundle", "SessionDatasetBundle", "SBCDatasetBundle"]:
        assert callable(getattr(tdatasets, name)), name
    assert {k: v.__name__ for k, v in tdatasets.DATASETS.items()} == {k: v.__name__ for k, v in jdatasets.DATASETS.items()}


@pytest.mark.parametrize("name", BUILDERS)
def test_dataset_builder_matches_the_jax_package(name):
    """Every bundle field: the arrays (and their dtypes), the feature names, vocab sizes and embed dims."""
    assert_same(seeded(getattr(tdatasets, name)), seeded(getattr(jdatasets, name)), name)


@pytest.mark.parametrize("kwargs", [dict(mode=0, neg_ratio=3), dict(mode=1, embed_dim=8, seq_max_len=10)], ids=["pointwise", "pairwise"])
def test_matching_builder_modes_match_the_jax_package(kwargs):
    assert_same(seeded(tdatasets.build_ml1m_matching_dataset, **kwargs), seeded(jdatasets.build_ml1m_matching_dataset, **kwargs), str(kwargs))


def test_synthetic_fallbacks_and_the_aliccp_frame_match(tmp_path, monkeypatch):
    """Without the committed samples every builder draws its synthetic sample; both packages draw the same.  The
    Ali-CCP frame (the helper both Ali-CCP builders read) too, with the sample and without."""
    assert_same(tdatasets._aliccp_frame(3, 100), jdatasets._aliccp_frame(3, 100), "_aliccp_frame")
    monkeypatch.setattr(tdatasets, "DATA_DIR", str(tmp_path))
    monkeypatch.setattr(jdatasets, "DATA_DIR", str(tmp_path))
    assert_same(tdatasets._aliccp_frame(3, 100, str(tmp_path / "none.csv")), jdatasets._aliccp_frame(3, 100, str(tmp_path / "none.csv")), "_aliccp_frame synthetic")
    for name in BUILDERS:
        kwargs = {"dataset_path": str(tmp_path / "none.csv")} if "dataset_path" in getattr(jdatasets, name).__code__.co_varnames else {}
        assert_same(seeded(getattr(tdatasets, name), **kwargs), seeded(getattr(jdatasets, name), **kwargs), name + " synthetic")


def flax_variables(jmodel, batch):
    """The flax model's ``params`` and ``batch_stats`` as zeros of their shapes (nothing compiles)."""
    rngs = {"params": jax.random.PRNGKey(0), "routing": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}
    shapes = jax.eval_shape(lambda b: jmodel.init(rngs, b, training=False), {k: jax.numpy.asarray(v) for k, v in batch.items()})
    zeros = lambda tree: jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), dict(tree))  # noqa: E731
    return zeros(shapes["params"]), zeros(shapes.get("batch_stats", {}))


def assert_same_parameters(model, jmodel, batch):
    """The port's model holds the flax model's parameters and statistics, by name and shape: the carrier loads them
    strictly, and every shape agrees."""
    params, stats = flax_variables(jmodel, batch)
    want = {k: tuple(v.shape) for k, v in {**flax_to_state_dict(params), **flax_to_state_dict(stats)}.items()}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    load_flax_params(model, params, stats)


REGISTRIES = [("ranking", n) for n in sorted(jmodels.RANKING_MODELS)] + [("matching", n) for n in sorted(jmodels.MATCHING_MODELS)] + [("multitask", n) for n in sorted(jmodels.MULTITASK_MODELS)]
BUNDLES = {"ranking": "build_criteo_ranking_dataset", "matching": "build_ml1m_matching_dataset", "multitask": "build_census_multitask_dataset"}


@pytest.mark.parametrize("family,name", REGISTRIES, ids=lambda x: x)
def test_model_builder_gives_the_jax_parameters(family, name):
    jbundle, tbundle = seeded(getattr(jdatasets, BUNDLES[family])), seeded(getattr(tdatasets, BUNDLES[family]))
    jmodel = getattr(jmodels, f"build_{family}_model")(name, jbundle)
    model = getattr(tmodels, f"build_{family}_model")(name, tbundle, generator=torch.Generator().manual_seed(0), device="cpu")
    assert_same_parameters(model, jmodel, {k: v[:8] for k, v in jbundle.x_train.items()})


def test_model_builders_pass_model_params_and_name_the_registry():
    assert tmodels.RANKING_MODELS == jmodels.RANKING_MODELS and tmodels.MATCHING_MODELS == jmodels.MATCHING_MODELS and tmodels.MULTITASK_MODELS == jmodels.MULTITASK_MODELS
    bundle, jbundle = tdatasets.build_criteo_ranking_dataset(), jdatasets.build_criteo_ranking_dataset()
    params = {"n_cross_layers": 1, "mlp_params": {"dims": (8,), "dropout": 0.0}}
    assert_same_parameters(tmodels.build_ranking_model("DCNv2", bundle, params, device="cpu"), jmodels.build_ranking_model("DCNv2", jbundle, params), {k: v[:8] for k, v in jbundle.x_train.items()})
    for family, builder in BUNDLES.items():
        with pytest.raises(KeyError, match="unknown"):
            getattr(jmodels, f"build_{family}_model")("NoSuchModel", seeded(getattr(jdatasets, builder)))
        with pytest.raises(KeyError, match="unknown"):
            getattr(tmodels, f"build_{family}_model")("NoSuchModel", seeded(getattr(tdatasets, builder)))


@pytest.mark.parametrize("beyond", [False, True], ids=["accuracy", "beyond_accuracy"])
@pytest.mark.parametrize("multi_interest", [False, True], ids=["single", "multi_interest"])
def test_evaluate_retrieval_matches_the_jax_package(beyond, multi_interest, capsys):
    """The same user and item embeddings through both ``evaluate_retrieval``s: every metric (and their names)."""
    bundle = seeded(jdatasets.build_ml1m_matching_dataset)
    rng = np.random.default_rng(3)
    n_users, n_items = len(bundle.test_user["user_id"]), len(bundle.x_all_item["movie_id"])
    user = rng.normal(size=(n_users, 2, 16) if multi_interest else (n_users, 16)).astype(np.float32)
    item = rng.normal(size=(n_items, 16)).astype(np.float32)
    args = (user, item, bundle.test_user, bundle.x_all_item, "user_id", "movie_id", 10, beyond)
    ref = jmetrics.evaluate_retrieval(*args)
    got = tmetrics.evaluate_retrieval(*args, device="cpu")
    assert list(got) == list(ref) and len(ref) == (9 if beyond else 5)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=METRIC_RTOL, err_msg=k)
