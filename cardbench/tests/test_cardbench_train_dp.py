"""The ``train_dp`` driver on two gloo ranks on the CPU: a sound run is correct with replicas that agree, and a
step that skips the gradients' all-reduce (``faults_dp.no_exchange``) is not."""

import time
from types import SimpleNamespace

import torch

from cardbench import faults_dp, harness
from cardbench.tests import common

TINY = common.TINY["hstu-books.train-dp4"]


def run(fault=None, trace=0):
    args = SimpleNamespace(workload="hstu-books.train-dp4", seed=2**31 + 4343, seconds=0.3, trace=trace)
    return harness.run(args, time.perf_counter(), device=torch.device("cpu"), overrides=TINY, fault=fault)


def test_a_sound_run_is_correct_and_its_replicas_agree():
    out = run(trace=1)
    assert out["correct"] is True and out["checks"]["replica_gap"]["value"] == 0.0 and out["attempted"] > 0
    assert {"step_mfu.train", "step_host_ms.train"} <= set(out["metrics"])


def test_skipping_the_exchange_is_not_correct():
    out = run(faults_dp.no_exchange)
    assert out["correct"] is False and out["checks"]["replica_gap"]["value"] > out["checks"]["replica_gap"]["limit"]



def test_the_traced_work_is_rank_0s_own_rows():
    """The kernel readers (the attention's rooflines) hold rank 0's trace to the work of rank 0's rows; the
    window's FLOPs stay every rank's."""
    from cardbench.drivers.train import TRACED_STEPS
    from cardbench.generators import GENERATORS

    seed, c = 2**31 + 4344, harness.resolve("hstu-books.train-dp4", TINY)
    out = c.driver.run(c, seed, 0.3, True, torch.device("cpu"), time.perf_counter(), overrides=TINY)
    pool = GENERATORS[c.traffic["generator"]](c.traffic, c.cfg, seed, torch.device("cpu"))
    share = c.traffic["batch"] // c.traffic["ranks"]
    own = c.kind.work({k: t[:, :share] for k, t in pool.items()})
    at = c.traffic["first_steps"] + out["attempted"]
    assert out["traced_work"] == [own[(at + i) % len(own)] for i in range(TRACED_STEPS)]
    assert all(w["rows"] == share for w in out["traced_work"])
