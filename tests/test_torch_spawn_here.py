"""``parallel.distributed.spawn(..., here=0)``: rank 0 runs in the calling process and its result comes back; the
other ranks run in new processes, and a collective joins them all (gloo on the CPU).  Another rank's failure
raises in the calling process, which goes on."""

import threading
import time
from types import SimpleNamespace

import pytest
import torch
import torch.distributed as dist

from torch_rechub_tpu_torch.parallel import distributed as pdist


def summed_rank(rank: int, scale: float):
    total = pdist.all_reduce(torch.tensor([float(rank) * scale]), dist.group.WORLD)
    return {"rank": rank, "total": float(total), "pid_world": dist.get_world_size()}


def test_spawn_runs_one_rank_here_and_returns_its_result():
    out = pdist.spawn(summed_rank, 3, args=(2.0,), backend="gloo", timeout_s=120, here=0)
    assert out == {"rank": 0, "total": 2.0 * (0 + 1 + 2), "pid_world": 3}
    assert not dist.is_initialized()  # the calling process's group is gone after


def test_spawn_without_here_returns_nothing():
    assert pdist.spawn(summed_rank, 2, args=(1.0,), backend="gloo", timeout_s=120) is None


def fails_off_rank_0(rank: int):
    if rank != 0:
        raise ValueError("rank 1 fails before the collective")
    return summed_rank(rank, 1.0)


def test_another_ranks_failure_raises_here_and_leaves_no_group():
    with pytest.raises(Exception):
        pdist.spawn(fails_off_rank_0, 2, backend="gloo", timeout_s=120, here=0)
    assert not dist.is_initialized()


def test_the_watchdog_aborts_the_group_5_s_after_a_rank_failed_and_not_once_done(tmp_path):
    failed, running = SimpleNamespace(exitcode=1), SimpleNamespace(exitcode=None)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0, world_size=1)
    try:
        done = threading.Event()
        done.set()
        pdist._abort_if_a_rank_fails([failed], done)  # done already: the group stays
        assert dist.is_initialized()
        start = time.monotonic()
        pdist._abort_if_a_rank_fails([running, failed], threading.Event())
        assert not dist.is_initialized() and 5.0 <= time.monotonic() - start < 30.0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
