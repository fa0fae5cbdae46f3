"""``utils/model_utils.py`` against the JAX package's: the feature schema a model's attributes give, the dummy
inputs (bit for bit for a seed: numpy draws in both), the parameter count on carried weights (a tied table
once), and ``model_summary``'s rows, total and FLOP line (``FlopCounterMode``, with the registered K1 op counted
by its formula ``2·B·H·L²·(dqk + dv)``; not compared with XLA's ``cost_analysis``, which counts other operations).
"""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from test_torch_ctr_model import carried_deepfm
from test_torch_export import carried_dssm, carried_hstu
from test_torch_seq_eval import MODEL_KW
from torch_rechub_tpu.basic import features as jfeat
from torch_rechub_tpu.utils import model_utils as jmu
from torch_rechub_tpu_torch.basic import features as tfeat
from torch_rechub_tpu_torch.utils import model_utils as tmu


def schema(feat):
    return [feat.SequenceFeature("hist", vocab_size=40, embed_dim=4, pooling="mean"), feat.SparseFeature("user", vocab_size=9, embed_dim=4),
            feat.DenseFeature("price"), feat.DenseFeature("vec", embed_dim=3), feat.SparseFeature("user", vocab_size=9, embed_dim=4)]


@pytest.mark.parametrize("seed", [0, 7])
def test_dummy_input_is_jax_s_bit_for_bit(seed):
    got = tmu.generate_dummy_input(features=schema(tfeat), batch_size=5, seq_length=6, seed=seed)
    ref = jmu.generate_dummy_input(features=schema(jfeat), batch_size=5, seq_length=6, seed=seed)
    assert list(got) == list(ref) == ["hist", "user", "price", "vec"]
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k
    with pytest.raises(ValueError, match="provide model or features"):
        tmu.generate_dummy_input()


@pytest.mark.parametrize("name", ["deepfm", "dssm"])
def test_feature_info_dummy_input_and_count_match_jax(name):
    jmodel, variables, model = carried_deepfm() if name == "deepfm" else carried_dssm()[:3]
    info, jinfo = tmu.extract_feature_info(model), jmu.extract_feature_info(jmodel)
    assert {k: [f.name for f in v] for k, v in info.items()} == {k: [f.name for f in v] for k, v in jinfo.items()}
    got, ref = tmu.generate_dummy_input(model, seed=3), jmu.generate_dummy_input(jmodel, seed=3)
    assert got.keys() == ref.keys() and all(np.array_equal(got[k], ref[k]) for k in ref)
    assert tmu.count_parameters(model) == jmu.count_parameters(variables) == jmu.count_parameters(variables["params"])
    assert tmu.count_parameters(dict(model.named_parameters())) == tmu.count_parameters(model)


def test_hstu_count_and_summary_flops():
    _, variables, model, toks = carried_hstu()
    assert tmu.count_parameters(model) == jmu.count_parameters(variables)  # the tied token table once
    summary = tmu.model_summary(model, x=(toks,))
    lines = summary.splitlines()
    assert lines[0] == "HSTUModel summary" and len([line for line in lines if line.startswith("hstu_block.")]) == sum(1 for n, _ in model.named_parameters() if n.startswith("hstu_block."))
    assert f"total parameters: {tmu.count_parameters(model):,}" in lines
    b, l = toks.shape
    h, dqk, dv, n_layers = MODEL_KW["n_heads"], MODEL_KW["dqk"], MODEL_KW["dv"], MODEL_KW["n_layers"]
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model.eval()(torch.as_tensor(toks))
    assert counter.get_flop_counts()["Global"][torch.ops.rechub.hstu_rab_fwd] == n_layers * 2 * b * h * l * l * (dqk + dv)
    assert lines[-1] == f"forward FLOPs/batch (torch.utils.flop_counter): {counter.get_total_flops():,}"
