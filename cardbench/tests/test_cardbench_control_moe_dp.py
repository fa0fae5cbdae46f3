"""On the cards: the control, the reference run in TF32 in the program's place, fails the limits of the expert
cell and of the four-card data-parallel cell.

At the cells' widths with fewer rows, so that a test run holds it; the
four-card cell needs four cards:

    python -m pytest -m cuda cardbench/tests/test_cardbench_control_moe_dp.py

The limits were set from ``cardbench/readings.py`` at the cells' own sizes
(``PERF.md``).
"""

import time

import pytest
import torch

from cardbench import control, harness, judge

pytestmark = pytest.mark.cuda
SEED = 2**31 + 2603


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_the_tf32_control_of_the_expert_cell_is_not_correct(card):
    c = harness.resolve("hllm-dsv2lite-books.train", {"traffic": {"batch": 64, "pool_batches": 4}})
    out = c.driver.run(c, SEED, 0.5, False, card, time.perf_counter())
    assert out["correct"], out["checks"]
    checks = control.checks(c, out, SEED, card)
    assert not judge.verdict(checks, c.limits), checks


def test_the_tf32_control_of_the_four_card_cell_is_not_correct(card):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    from cardbench import readings

    c = harness.resolve("hstu-books.train-dp4", {"traffic": {"batch": 64, "pool_batches": 4}})
    out = c.driver.run(c, SEED, 0.5, False, card, time.perf_counter())
    assert out["correct"], out["checks"]
    # the reference is one replica: the control has no replica_gap of its own, so it takes the program's
    checks = {**readings.control(c, out, SEED, card), "replica_gap": out["checks"]["replica_gap"]}
    assert not judge.verdict(checks, c.limits), checks
