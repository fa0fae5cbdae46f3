"""The ``hllm-dsv2lite-books`` configuration: its file against the source, the kind's leaves against the model's,
the FLOP count by hand, its traffic, and whole tiny runs on the CPU, each planted fault failing them."""

import json
import math
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from cardbench import faults, faults_moe, harness
from cardbench.counts import moe as counts
from cardbench.kinds import hllm_moe
from cardbench.tests import common

ROOT = Path(__file__).resolve().parents[2]
CFG = json.loads((ROOT / "cardbench" / "configs" / "hllm-dsv2lite-books.json").read_text())
CELL = "hllm-dsv2lite-books.train"
TINY = common.TINY[CELL]


def test_the_file_keeps_every_published_key_but_those_it_lists_as_reduced():
    published = {k: v for k, v in CFG["published"].items() if k not in ("note", "torch_dtype")}
    changed = sorted(k for k, v in published.items() if CFG.get(k, "missing") != v)
    assert changed == sorted(set(CFG["reduced"]) - {"torch_dtype"}) and CFG["torch_dtype"] == "float32"
    assert CFG["n_routed_experts_router"] == published["n_routed_experts"] == 64 and CFG["n_routed_experts"] == 8 and CFG["num_hidden_layers"] == 9
    widths = [k for k in CFG["reduced"] if k.endswith(("_dim", "_rank")) or k in ("hidden_size", "intermediate_size", "moe_intermediate_size", "num_experts_per_tok")]
    assert widths == [] and set(CFG["departures"]) >= set(CFG["reduced"])


def test_the_kind_lists_the_model_leaves():
    cfg = {**CFG, **TINY["config"]}
    model = hllm_moe.build_model(cfg, {n: torch.zeros(s) for n, s, _, _ in hllm_moe.specs(cfg)}, 7, torch.device("cpu"))
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == {n: s for n, s, _, _ in hllm_moe.specs(cfg)}


def test_the_full_size_leaves_hold_the_reckoned_parameters():
    sizes = {n: math.prod(s) for n, s, _, _ in hllm_moe.specs(CFG)}
    layer0 = sum(v for n, v in sizes.items() if n.startswith("layers.0."))
    layer1 = sum(v for n, v in sizes.items() if n.startswith("layers.1."))
    assert 80e6 < layer0 < 82e6 and 100e6 < layer1 < 101e6 and 0.88e9 < sum(sizes.values()) < 0.89e9


def test_the_flop_count_by_hand():
    cfg = {**CFG, **TINY["config"], "num_negatives": 32}
    d, h, c, n, r, dv = 64, 4, 16, 16, 8, 16
    mla = 2 * (d * h * (n + r) + d * (c + r) + c * h * (n + dv) + h * dv * d)
    pair = 2 * h * (n + r + dv)
    dense = 3 * 2 * d * 96
    expert = 2 * d * 8 + 3 * 2 * d * 64 + 2 * 4 / 8 * 3 * 2 * d * 32
    tokens, pairs = 10, 30
    forward = 3 * (tokens * mla + pairs * pair) + tokens * dense + 2 * tokens * expert
    assert counts.hllm_moe_train_step_flops(cfg, tokens, pairs) == pytest.approx(3 * (forward + 2 * tokens * d * 33))
    assert counts.mla_position_flops(CFG) == 27525120 and counts.mlp_flops(2048, 2816) == 34603008


def test_the_traffic_is_train_histories_at_the_global_batch():
    base = json.loads((ROOT / "cardbench" / "traffic" / "train-histories.json").read_text())
    b512 = json.loads((ROOT / "cardbench" / "traffic" / "train-histories-b512.json").read_text())
    dp4 = json.loads((ROOT / "cardbench" / "traffic" / "train-histories-dp4.json").read_text())
    law = ("history_len", "length_min", "length_log_median", "length_log_sigma", "first_steps", "item_popularity_exponent", "gap_log_median_s", "gap_log_sigma")
    assert all(b512[k] == base[k] == dp4[k] for k in law)
    assert (b512["batch"], b512["pool_batches"], b512["driver"]) == (512, 16, "train")
    assert (dp4["batch"] // dp4["ranks"], dp4["ranks"], dp4["driver"]) == (base["batch"], 4, "train_dp")


def run(fault=None, trace=0, seed=2**31 + 4242):
    args = SimpleNamespace(workload=CELL, seed=seed, seconds=0.2, trace=trace)
    return harness.run(args, time.perf_counter(), device=torch.device("cpu"), overrides=TINY, fault=fault)


def test_a_sound_tiny_run_is_correct_and_reports_its_layer_metrics():
    out = run(trace=1)
    assert out["correct"] is True and out["attempted"] > 0
    assert {"step_mfu.train", "moe_load_max_over_mean.train", "step_host_ms.train"} <= set(out["metrics"])
    assert out["metrics"]["moe_load_max_over_mean.train"]["value"] >= 1.0


PLANTED = {**faults.TRAIN, **faults_moe.MOE}


@pytest.mark.parametrize("name", sorted(PLANTED))
def test_a_planted_fault_is_not_correct(name):
    out = run(PLANTED[name])
    assert out["correct"] is False and any(c["value"] > c["limit"] for c in out["checks"].values())


def test_the_reference_copy_is_the_port_reference():
    port = ROOT / "torch_rechub_tpu_torch" / "reference" / "hllm_deepseek_v2.py"
    assert (ROOT / "cardbench" / "reference" / "hllm_moe.py").read_text() == port.read_text()
