"""The traffic generators are fixed by the seed, differ across seeds, and draw what their files say."""

import json
from pathlib import Path

import pytest
import torch

from cardbench.generators import GENERATORS
from cardbench.sampling import power_law_ranks, sub_seed

HERE = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
CASES = {
    "train-histories": ({"vocab_size": 5000}, {"batch": 3, "pool_batches": 2}),
    "serve-histories": ({"vocab_size": 5000}, {"batch": 3, "pool_batches": 2}),
    "train-impressions": ({"cardinalities": [1460, 583, 10131227, 3], "n_dense": 13}, {"batch": 64, "pool_batches": 2}),
}


def draw(name, seed):
    cfg, small = CASES[name]
    traffic = {**json.loads((HERE / "traffic" / f"{name}.json").read_text()), **small}
    return traffic, GENERATORS[traffic["generator"]](traffic, cfg, seed, CPU)


@pytest.mark.parametrize("name", sorted(CASES))
def test_fixed_by_the_seed_and_different_across_seeds(name):
    _, a = draw(name, 2**31 + 977)
    _, b = draw(name, 2**31 + 977)
    _, c = draw(name, 2**31 + 978)
    assert a.keys() == b.keys() == c.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(a[k].shape == c[k].shape and a[k].dtype == c[k].dtype for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a if k != "weight")


@pytest.mark.parametrize("name", ["train-histories", "serve-histories"])
def test_histories_are_left_padded_with_the_same_lengths_on_every_seed(name):
    traffic, h = draw(name, 12345)
    _, other = draw(name, 2**31 + 3)
    valid = h["tokens"] != 0
    lengths = valid.sum(-1)
    assert h["tokens"].shape == (2, 3, traffic["history_len"]) and (h["tokens"] < 5000).all() and (h["targets"] >= 1).all()
    assert (lengths >= traffic["length_min"]).all() and (lengths <= traffic["history_len"]).all()
    assert torch.equal(valid, torch.arange(traffic["history_len"]) >= traffic["history_len"] - lengths[..., None])  # PAD first
    assert torch.equal(lengths.flatten().sort().values, (other["tokens"] != 0).sum(-1).flatten().sort().values)
    assert ((h["times"] == 0) == ~valid).all()
    t = torch.where(valid, h["times"], 2**31 - 1)
    assert (t[..., :-1] >= t[..., 1:]).all()  # seconds before the request fall along the history


def test_history_lengths_follow_the_books_counts():
    traffic = json.loads((HERE / "traffic" / "train-histories.json").read_text())
    from cardbench.generators import history_lengths

    n = history_lengths(traffic, 64 * 128, torch.Generator().manual_seed(5), CPU).double()
    assert 13.0 < float(n.mean()) < 15.0 and int(n.min()) == 5 and int(n.max()) == 50
    assert 0.01 < float((n == 50).double().mean()) < 0.04


def test_impressions_stay_in_each_field():
    _, x = draw("train-impressions", 99)
    for i, rows in enumerate(CASES["train-impressions"][0]["cardinalities"]):
        assert x[f"C{i}"].dtype == torch.int32 and int(x[f"C{i}"].min()) >= 0 and int(x[f"C{i}"].max()) < rows
    assert set(x["label"].unique().tolist()) <= {0.0, 1.0} and (x["weight"] == 1).all()


def test_power_law_favours_low_ranks():
    r = power_law_ranks((200000,), 1000, 1.2, torch.Generator().manual_seed(1), CPU)
    counts = torch.bincount(r, minlength=1001)
    assert int(r.min()) >= 1 and int(r.max()) <= 1000 and counts[1] > 5 * counts[10] > 0


def test_sub_seeds_are_large_and_distinct():
    seeds = {sub_seed(s, p) for s in (0, 2**31 + 5, 2**33) for p in ("weights", "histories")}
    assert len(seeds) == 6 and all(0 <= s < 2**63 for s in seeds)
