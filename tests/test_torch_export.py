"""Export and quantized export (``utils/export.py``, ``TorchTrainer.export`` / ``export_quantized`` /
``visualization``) against the JAX package's ``StableHLOExporter``, mirroring ``tests/test_export.py``.

On the JAX package's initial weights carried into the port: DeepFM in full, DSSM's user and item towers and a
2-layer HSTU, each exported by both packages and loaded back by each package's ``load_exported``, the outputs
compared at ``tests/test_export.py``'s rtol 1e-5, atol 1e-6 (HSTU at its LayerNorm tolerance 2e-4 relative,
``test_torch_hstu_model.py``).  ``quantize_params``' ``q`` is the JAX package's int8 bit for bit and its
``scale`` and ``quantization_error`` equal the JAX package's, for every 2-D parameter; the int8 and fp16
exports' outputs match the JAX package's quantized exports at the same tolerances (the same quantized weights,
dequantized in the program), and the artifact shrinks.  The exported HSTU holds the registered K1 op
``rechub::hstu_rab_fwd`` (one call a layer) and none of the plain version's operations.
"""

import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ctr_model import MLP_PARAMS, carried_deepfm, ctr_batch, np_tree
from test_torch_seq_eval import MODEL_KW, seq_data
from torch_rechub_tpu.basic import features as jfeat
from torch_rechub_tpu.models.generative.hstu import HSTUModel as JHSTUModel
from torch_rechub_tpu.models.matching import DSSM as JDSSM
from torch_rechub_tpu.utils import export as jexport
from torch_rechub_tpu_torch.basic import features as tfeat
from torch_rechub_tpu_torch.models.generative.hstu import HSTUModel
from torch_rechub_tpu_torch.models.matching import DSSM
from torch_rechub_tpu_torch.trainers import CTRTrainer
from torch_rechub_tpu_torch.utils import data as tdata
from torch_rechub_tpu_torch.utils import export as texport
from torch_rechub_tpu_torch.utils.jax_weights import flax_to_state_dict, load_flax_params
from torch_rechub_tpu_torch.utils.model_utils import generate_dummy_input

RTOL, ATOL = 1e-5, 1e-6  # tests/test_export.py
HSTU_RTOL = 2e-4
TOWER = {"dims": (8,)}


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def carried_dssm():
    def feats(feat):
        return (feat.SparseFeature("user_id", vocab_size=30, embed_dim=8),), (feat.SparseFeature("item_id", vocab_size=50, embed_dim=8),)

    rng = np.random.default_rng(0)
    x = {"user_id": rng.integers(0, 30, 8).astype(np.int32), "item_id": rng.integers(0, 50, 8).astype(np.int32)}
    ju, ji = feats(jfeat)
    jmodel = JDSSM(user_features=ju, item_features=ji, user_params=TOWER, item_params=TOWER)
    variables = np_tree(jmodel.init(jax.random.PRNGKey(0), x, training=False))
    tu, ti = feats(tfeat)
    return jmodel, variables, load_flax_params(DSSM(tu, ti, TOWER, TOWER), variables["params"], variables.get("batch_stats")), x


def carried_hstu():
    toks, _, _, tds = seq_data(n=4, seed=3)
    jmodel = JHSTUModel(**MODEL_KW)
    variables = {"params": np_tree(jmodel.init(jax.random.PRNGKey(2), jnp.asarray(toks), jnp.asarray(tds), training=False)["params"])}
    return jmodel, variables, load_flax_params(HSTUModel(**MODEL_KW), variables["params"]), toks


def models():
    jmodel, variables, model = carried_deepfm()
    return {"deepfm": (jmodel, variables, model, ctr_batch(16, seed=4), None), "dssm_user": (*carried_dssm(), "user"), "dssm_item": (*carried_dssm(), "item"),
            "hstu": (*carried_hstu(), None)}


MODELS = ("deepfm", "dssm_user", "dssm_item", "hstu")


def tol(name):
    return dict(rtol=HSTU_RTOL if name == "hstu" else RTOL, atol=ATOL)


def weight_bytes(path):
    """The bytes of a ``.pt2`` archive's weights (its ``data/weights/`` entries; a small model's file is mostly its graph)."""
    with zipfile.ZipFile(path) as archive:
        return sum(i.file_size for i in archive.infolist() if "/data/weights/" in i.filename)


def jax_run(path):
    run, variables = jexport.load_exported(path)
    return lambda x: np.asarray(run(jax.tree_util.tree_map(jnp.asarray, x))), variables


@pytest.mark.parametrize("name", MODELS)
def test_export_matches_jax_export(tmp_path, name):
    jmodel, variables, model, x, mode = models()[name]
    jrun, _ = jax_run(jexport.StableHLOExporter(jmodel, variables).export(str(tmp_path / "jax"), x, mode=mode))
    path = texport.TorchExporter(model).export(str(tmp_path / "port"), x, mode=mode)
    assert path.endswith(".pt2") and os.path.isfile(path)
    run, state = texport.load_exported(path)
    out = run(x)
    np.testing.assert_allclose(out.numpy(), jrun(x), **tol(name))
    with torch.no_grad():
        eager = model.eval()(*[torch.as_tensor(x)] if name == "hstu" else [{k: torch.as_tensor(v) for k, v in x.items()}], **({"mode": mode} if mode else {}))
    assert torch.equal(out, eager)  # the program runs the model's own operations
    assert len(state) == len(dict(model.named_parameters())) + len(dict(model.named_buffers()))
    if name == "hstu":
        program = torch.export.load(path)
        targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
        assert targets.count("rechub.hstu_rab_fwd.default") == MODEL_KW["n_layers"]
        # the plain version's mask and second silu are not in the program: one silu a layer, proj1's (Eq. 2)
        assert not [t for t in targets if "tril" in t or "masked_fill" in t] and targets.count("aten.silu.default") == MODEL_KW["n_layers"]


@pytest.mark.parametrize("name", MODELS)
def test_quantize_params_is_jax_s_bit_for_bit(name):
    _, variables, model, _, _ = models()[name]
    params = dict(model.named_parameters())
    rows = texport.linear_weight_names(model)
    jq = {}  # the JAX package's leaves by the port's names
    for path, leaf in jax.tree_util.tree_flatten_with_path(jexport.quantize_params(variables["params"], "int8"), is_leaf=lambda v: isinstance(v, dict) and set(v) == {"q", "scale"})[0]:
        (port_name,) = flax_to_state_dict({tuple(k.key for k in path): np.zeros((1, 1))})
        jq[port_name] = leaf
    q = texport.quantize_params(params, "int8", rows)
    assert set(q) == set(jq)
    n_quantized = 0
    for port_name, leaf in q.items():
        jleaf = jq[port_name]
        if isinstance(leaf, dict):
            n_quantized += 1
            jq_arr = np.asarray(jleaf["q"])
            np.testing.assert_array_equal(leaf["q"].numpy(), jq_arr.T if port_name in rows else jq_arr, err_msg=port_name)
            np.testing.assert_array_equal(leaf["scale"].numpy().reshape(-1), np.asarray(jleaf["scale"]), err_msg=port_name)
        else:
            assert not isinstance(jleaf, dict), port_name
    assert n_quantized == sum(p.ndim == 2 for p in params.values()) > 0
    for mode in ("int8", "fp16"):
        assert texport.quantization_error(params, mode, rows) == jexport.quantization_error(variables["params"], mode)
    deq = texport.dequantize_params(q)
    assert all(d.dtype == torch.float32 and d.shape == params[n].shape for n, d in deq.items())


@pytest.mark.parametrize("quant_mode", ["int8", "fp16"])
@pytest.mark.parametrize("name", MODELS)
def test_quantized_export_matches_jax_s(tmp_path, name, quant_mode):
    jmodel, variables, model, x, mode = models()[name]
    jexporter = jexport.StableHLOExporter(jmodel, variables)
    jrun, _ = jax_run(jexporter.export_quantized(str(tmp_path / "jax"), x, mode=mode, quant_mode=quant_mode))
    exporter = texport.TorchExporter(model)
    full = exporter.export(str(tmp_path / "full"), x, mode=mode)
    path = exporter.export_quantized(str(tmp_path / quant_mode), x, mode=mode, quant_mode=quant_mode)
    run, state = texport.load_exported(path)
    np.testing.assert_allclose(run(x).numpy(), jrun(x), **tol(name))
    want = torch.int8 if quant_mode == "int8" else torch.float16
    assert any(t.dtype == want for t in state.values())
    assert weight_bytes(path) < weight_bytes(full)


def test_trainer_export_quantized_and_visualization(tmp_path):
    """Before a step the trainer refuses to export, as the JAX trainer before ``fit``; after one it exports the
    trained model (``generate_dummy_input``'s example by default) and prints its summary."""
    _, _, model = carried_deepfm()
    trainer = CTRTrainer(model, model_path=str(tmp_path), device="cpu")
    with pytest.raises(RuntimeError, match=r"export\(\) requires a trained/initialized model — call fit\(\) first"):
        trainer.export(str(tmp_path / "early"))
    x = ctr_batch(16, seed=5)
    trainer.train_one_epoch(tdata.ArrayLoader(x, np.random.default_rng(5).integers(0, 2, 16).astype(np.float32), batch_size=8), log_interval=0)
    run, _ = texport.load_exported(trainer.export(str(tmp_path / "deepfm")))  # at the dummy input's static shapes
    run_q, _ = texport.load_exported(trainer.export_quantized(str(tmp_path / "deepfm_int8"), x))
    dummy = generate_dummy_input(model)
    with torch.no_grad():
        expected = model.eval()({k: torch.as_tensor(v) for k, v in x.items()})
        assert torch.equal(run(dummy), model({k: torch.as_tensor(v) for k, v in dummy.items()}))
    assert float((run_q(x) - expected).abs().max()) < 0.05  # tests/test_export.py's atol for the int8 DeepFM
    summary = trainer.visualization(save_path=str(tmp_path / "summary.txt"))
    assert "total parameters" in summary and (tmp_path / "summary.txt").read_text() == summary
