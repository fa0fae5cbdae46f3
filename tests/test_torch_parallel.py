"""``parallel/`` against the JAX package's: the table placement policy (the cases of
``tests/test_table_placement.py``, warnings included), the seeds and row ranges of ``distributed.py``, and which
parameters ``param_shardings`` row-shards on the port's names.  The mesh's training runs are in
``tests/test_torch_mesh_train.py``."""

import re
import types
import warnings

import jax
import numpy as np
import pytest
import torch

from test_torch_cuda_mesh import HSTU_KW, deepfm, failing_rank
from torch_rechub_tpu.basic import features as jfeat
from torch_rechub_tpu.models import ranking as jranking
from torch_rechub_tpu.models.generative import HSTUModel as JHSTUModel
from torch_rechub_tpu.ops import embedding as jemb
from torch_rechub_tpu.parallel import distributed as jdist
from torch_rechub_tpu.parallel import mesh as jmesh
from torch_rechub_tpu_torch.basic import features as tfeat
from torch_rechub_tpu_torch.models import ranking as tranking
from torch_rechub_tpu_torch.models.generative import HSTUModel
from torch_rechub_tpu_torch.ops import embedding as temb
from torch_rechub_tpu_torch.parallel import distributed as tdist
from torch_rechub_tpu_torch.parallel import mesh as tmesh
from torch_rechub_tpu_torch.utils.jax_weights import flax_to_state_dict

PADDED_150K = -(-150_000 // 64) * 64
# tests/test_table_placement.py's six cases: (table shapes, n_model, keyword arguments)
PLACEMENT_CASES = {
    "single_model_axis_replicates_everything": ({"a": (10_000_000, 64)}, 1, {}),
    "large_divisible_table_shards": ({"a": (1 << 20, 16), "b": (100, 16)}, 4, {}),
    "150k_table_shards_at_model_4": ({"t": (PADDED_150K, 16)}, 4, {}),
    "indivisible_large_table_warns_and_replicates": ({"odd": (tmesh.SHARD_MIN_ROWS + 1, 16)}, 4, {}),
    "budget_forces_sharding_below_threshold": ({f"t{i}": (32_768, 128) for i in range(3)}, 2, {"hbm_budget_bytes": 40 << 20}),
    "padded_per_feature_table": ({"big_table": (PADDED_150K, 8), "small_table": (50, 8)}, 4, {}),
}


def placement(module, shapes, n_model, kw):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        plan = module.plan_table_placement(shapes, n_model, **kw)
    return plan, [str(w.message) for w in caught]


@pytest.mark.parametrize("case", PLACEMENT_CASES)
def test_plan_table_placement_equals_the_jax_package(case):
    shapes, n_model, kw = PLACEMENT_CASES[case]
    assert placement(tmesh, shapes, n_model, kw) == placement(jmesh, shapes, n_model, kw)
    assert tmesh.SHARD_MIN_ROWS == jmesh.SHARD_MIN_ROWS and tmesh.DEFAULT_TABLE_HBM_BUDGET == jmesh.DEFAULT_TABLE_HBM_BUDGET


def test_the_budget_case_shards_one_table_and_a_generous_budget_none():
    shapes = {f"t{i}": (32_768, 128) for i in range(3)}
    assert sorted(tmesh.plan_table_placement(shapes, n_model=2, hbm_budget_bytes=40 << 20).values()) == ["replicate", "replicate", "shard"]
    assert set(tmesh.plan_table_placement(shapes, n_model=2, hbm_budget_bytes=1 << 30).values()) == {"replicate"}


@pytest.mark.parametrize("vocab", (1000, 65536, 65536 + 64, 65537))
def test_table_partition_spec_equals_the_jax_package(vocab):
    jax_mesh = jmesh.create_mesh(data=4, model=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert tmesh.table_partition_spec(vocab, types.SimpleNamespace(shape={"data": 4, "model": 2})) == tuple(jmesh.table_partition_spec(vocab, jax_mesh))
    assert tmesh.table_partition_spec(vocab, None) == tuple(jmesh.table_partition_spec(vocab, None)) == ()


def test_global_batch_seed_and_host_batch_slice_are_the_jax_packages():
    for base in (0, 1, 7, 12345, 2**31 - 2, 10**12):
        for step in (0, 1, 99, 10**6):
            assert tdist.global_batch_seed(base, step) == jdist.global_batch_seed(base, step)
    for n in (1, 7, 64, 4096):
        assert tdist.host_batch_slice(n) == jdist.host_batch_slice(n)
    info = tdist.process_info()
    assert (info["process_index"], info["process_count"]) == (jax.process_index(), jax.process_count())


def jax_sharded_names(model, x):
    """The leaves the JAX package's ``param_shardings`` row-shards under a (4, 2) mesh, by the port's names."""
    params = model.init(jax.random.PRNGKey(0), *x, training=False)["params"]
    shardings = jmesh.param_shardings(params, jmesh.create_mesh(data=4, model=2))
    flat = jax.tree_util.tree_flatten_with_path(shardings, is_leaf=lambda s: isinstance(s, jax.sharding.NamedSharding))[0]
    names = {".".join(re.findall(r"\['([^']+)'\]", jax.tree_util.keystr(p))) for p, s in flat if s.spec == jax.sharding.PartitionSpec("model", None)}
    return names, set(flax_to_state_dict(params))


def ctr_batch():
    rng = np.random.default_rng(0)
    x = {f"C{i}": rng.integers(0, 64, 8).astype(np.int32) for i in range(4)}
    x["I0"] = rng.normal(size=8).astype(np.float32)
    return (x,)


@pytest.mark.parametrize("case", ("deepfm_fused", "deepfm_per_feature", "hstu_tied", "hstu_untied"))
def test_param_shardings_picks_the_jax_packages_tables(case):
    """A fused DeepFM (the fused table forced to shard), a per-feature one (tables too small: none), and HSTU at
    a vocab of SHARD_MIN_ROWS, tied (the token table) and untied (the output projection too)."""
    if case.startswith("deepfm"):
        fused = case == "deepfm_fused"
        old = (jemb.set_fused_default(fused), temb.set_fused_default(fused))
        try:
            want, jax_names = jax_sharded_names(deepfm(jfeat, jranking), ctr_batch())
            port = deepfm(tfeat, tranking)
        finally:
            jemb.set_fused_default(old[0])
            temb.set_fused_default(old[1])
    else:
        kw = dict(HSTU_KW, tie_embeddings=case == "hstu_tied")
        toks = np.ones((2, HSTU_KW["max_seq_len"]), np.int32)
        want, jax_names = jax_sharded_names(JHSTUModel(**kw), (toks, np.zeros_like(toks)))
        port = HSTUModel(**kw)
    plan = tmesh.param_shardings(port, types.SimpleNamespace(shape={"data": 4, "model": 2}))
    assert set(plan) == jax_names
    assert {k for k, v in plan.items() if v == "shard"} == want
    assert want or case == "deepfm_per_feature"
    assert set(tmesh.param_shardings(port, None).values()) == {None}


def test_a_mesh_needs_the_process_group_and_a_mesh_argument_must_be_one():
    with pytest.raises(RuntimeError, match="initialize"):
        tmesh.create_mesh(1, 1)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tmesh.check_mesh(object())
    assert tmesh.check_mesh(None) is None
    assert tmesh.batch_sharding(None) is None and tmesh.scan_batch_sharding(None) is None and tmesh.replicated_sharding(None) is None


def test_batch_sharding_keeps_the_data_index_rows():
    fake = types.SimpleNamespace(shape={"data": 2, "model": 2}, data_index=1, model_index=0)
    x = np.arange(3 * 8 * 2).reshape(3, 8, 2)
    np.testing.assert_array_equal(tmesh.BatchSharding(fake, 0).local(x[0]), x[0, 4:])
    np.testing.assert_array_equal(tmesh.BatchSharding(fake, 1).local(torch.from_numpy(x)).numpy(), x[:, 4:])
    assert tmesh.BatchSharding(fake, None).local(x) is x
    batch = {"a": x[0], "b": (x[1], None)}
    assert tmesh.shard_batch(batch, None) is batch
    local = tmesh.shard_batch(batch, fake)
    np.testing.assert_array_equal(local["a"], x[0, 4:])
    np.testing.assert_array_equal(local["b"][0], x[1, 4:])
    assert local["b"][1] is None
    with pytest.raises(ValueError, match="does not split"):
        tmesh.BatchSharding(fake, 0).local(np.zeros(7))


def test_spawn_raises_naming_the_failed_rank_and_stops_the_rest():
    """A rank that raises fails the job at once, named; the rank left waiting on it in a collective fails with it
    (gloo sees the peer go) or is killed, long before the timeout."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"spawn\(failing_rank\): ranks failed \{.*1: 1\}"):
        tdist.spawn(failing_rank, 2, timeout_s=120)
    assert time.monotonic() - t0 < 60
