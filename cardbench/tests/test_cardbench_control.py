"""On the card: the control, the reference run in TF32 in the program's place, fails the cell's limits.

At the cells' widths with fewer rows, so that a test run holds it:

    python -m pytest -m cuda cardbench/tests/test_cardbench_control.py

The chip readings that the limits were set from are those of
``cardbench/calibrate.py`` at the cells' own sizes (``PERF.md``).
"""

import time

import pytest
import torch

from cardbench import control, harness, judge

pytestmark = pytest.mark.cuda
SMALL = {
    "hstu-books.train": {"traffic": {"batch": 16, "pool_batches": 4}},
    "deepfm-criteo.train": {"traffic": {"batch": 8192, "pool_batches": 4}},
    "hstu-books.serve": {"traffic": {"batch": 16, "pool_batches": 8, "checked_requests": 4}},
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_tf32_control_is_not_correct(card, cell):
    c = harness.resolve(cell, SMALL[cell])
    out = c.driver.run(c, 2**31 + 99, 0.5, False, card, time.perf_counter())
    assert out["correct"], out["checks"]
    checks = control.checks(c, out, 2**31 + 99, card)
    assert not judge.verdict(checks, c.limits), checks
