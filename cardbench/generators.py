"""The general traffic generators, read from a traffic file's parameters.

``histories``: users' item histories for a sequence model, left-padded
with PAD (id 0) to ``history_len`` so that the last position is the latest
item: item ids by a power-law popularity over the catalogue, the next item
as the target, and per position the seconds before the request (the sum of
the later lognormal gaps; 0 at PAD).  A history holds ``length_min`` items
plus a lognormal count (``length_log_median``, ``length_log_sigma``), cut
at ``history_len``; the lengths are that law's quantiles at evenly spaced
points, one a history, in an order drawn from the seed, so every seed
holds the same lengths and so the same work.

``impressions``: CTR impressions: per categorical field an id by a Zipf
popularity over that field's rows, dense features N(0, 1), labels
Bernoulli at the positive rate, row weights 1.

Both return ``pool_batches`` batches stacked on the device; a run steps
through them in order, so the first steps see rows that all differ.
"""

from __future__ import annotations

from typing import Dict

import torch

from .sampling import generator, lognormal, power_law_ranks


def history_lengths(traffic: dict, count: int, gen: torch.Generator, device) -> torch.Tensor:
    """``count`` int64 lengths: the quantiles at ``(i + 0.5) / count`` of the traffic's length law, shuffled."""
    p = (torch.arange(count, device=device, dtype=torch.float64) + 0.5) / count
    extra = torch.floor(traffic["length_log_median"] * torch.exp(traffic["length_log_sigma"] * torch.special.ndtri(p)))
    lengths = torch.clamp(traffic["length_min"] + extra, traffic["length_min"], traffic["history_len"]).to(torch.int64)
    return lengths[torch.randperm(count, generator=gen, device=device)]


def histories(traffic: dict, config: dict, seed: int, device, pool: int = None) -> Dict[str, torch.Tensor]:
    """``{"tokens": (P, B, L) int64, "times": (P, B, L) int32, "targets": (P, B) int64}``."""
    pool = traffic["pool_batches"] if pool is None else pool
    b, l, v = traffic["batch"], traffic["history_len"], config["vocab_size"]
    gen = generator(seed, "histories", device)
    lengths = history_lengths(traffic, pool * b, gen, device).reshape(pool, b, 1)
    valid = torch.arange(l, device=device) >= l - lengths  # the last ``length`` positions hold items
    ids = power_law_ranks((pool, b, l + 1), v - 1, traffic["item_popularity_exponent"], gen, device)
    gaps = lognormal((pool, b, l), traffic["gap_log_median_s"], traffic["gap_log_sigma"], gen, device)
    # seconds before the request: the last item's own gap, plus every later gap
    before = torch.flip(torch.cumsum(torch.flip(gaps, [-1]), -1), [-1])
    times = torch.clamp(torch.round(before), 1, 2**31 - 1).to(torch.int32)
    return {"tokens": torch.where(valid, ids[..., :l], 0), "times": torch.where(valid, times, 0), "targets": ids[..., l].contiguous()}


def impressions(traffic: dict, config: dict, seed: int, device, pool: int = None) -> Dict[str, torch.Tensor]:
    """``{"C{i}": (P, B) int32, "I{i}": (P, B) float32, "label": (P, B) float32, "weight": (P, B) float32}``."""
    pool = traffic["pool_batches"] if pool is None else pool
    b = traffic["batch"]
    gen = generator(seed, "impressions", device)
    out = {}
    for i, rows in enumerate(config["cardinalities"]):
        out[f"C{i}"] = (power_law_ranks((pool, b), rows, traffic["id_zipf_exponent"], gen, device) - 1).to(torch.int32)
    dense = torch.randn((config["n_dense"], pool, b), generator=gen, device=device)
    out.update({f"I{i}": dense[i] for i in range(config["n_dense"])})
    out["label"] = (torch.rand((pool, b), generator=gen, device=device) < traffic["positive_rate"]).to(torch.float32)
    out["weight"] = torch.ones((pool, b), device=device)
    return out


GENERATORS = {"histories": histories, "impressions": impressions}
