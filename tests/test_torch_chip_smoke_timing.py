"""``chip_smoke.timed`` on the CPU, with the card's clock and spin wait faked.

``timed`` enqueues each call behind a device spin wait and measures a call
again behind a longer wait when the host took longer to enqueue it than the
device waited; more repeats than ``reps`` raise.  The fake below has a host
clock and a device timeline: a call of ``fn`` costs the host what the test
says and the device ``DEVICE_MS``; ``torch.cuda._sleep`` advances the device
by its cycles.
"""

import sys
import types
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

CYCLES_PER_MS = 1000.0
CYCLE_MS = 1 / CYCLES_PER_MS  # timed rounds a spin down to whole cycles
DEVICE_MS = 0.25


class FakeCard:
    def __init__(self, enqueue_ms):
        self.enqueue_ms = enqueue_ms  # (fake, call index) -> host ms of that call
        self.host_ms = 0.0
        self.device_ms = 0.0
        self.calls = 0
        self.sleeps_ms = []

    def fn(self):
        self.host_ms += self.enqueue_ms(self, self.calls)
        self.device_ms += DEVICE_MS
        self.calls += 1

    def perf_counter(self):
        return self.host_ms / 1e3

    def sleep(self, cycles):
        self.sleeps_ms.append(cycles / CYCLES_PER_MS)
        self.device_ms += cycles / CYCLES_PER_MS

    def event(self, enable_timing=False):
        card = self

        class Event:
            def record(self):
                self.t = card.device_ms

            def synchronize(self):
                pass

            def elapsed_time(self, end):
                return end.t - self.t

        return Event()


@pytest.fixture
def fake_card(monkeypatch):
    def install(enqueue_ms):
        card = FakeCard(enqueue_ms)
        monkeypatch.setattr(torch.cuda, "Event", card.event)
        monkeypatch.setattr(torch.cuda, "_sleep", card.sleep)
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
        monkeypatch.setattr(cs, "time", types.SimpleNamespace(perf_counter=card.perf_counter))
        return card

    return install


REPS, WARMUP = 5, 3


def test_timed_without_a_stall_measures_each_call_once(fake_card, capsys):
    card = fake_card(lambda card, i: 0.1)
    device, wall = cs.timed(card.fn, CYCLES_PER_MS, reps=REPS, warmup=WARMUP)
    assert device == pytest.approx(DEVICE_MS) and wall == pytest.approx(0.1)
    assert card.calls == WARMUP + 2 * REPS
    assert card.sleeps_ms == pytest.approx([3 * 0.1 + 1.0] * REPS, abs=CYCLE_MS)  # 3 x the slowest host-clock call + 1 ms
    assert "measured again" not in capsys.readouterr().out


def test_timed_measures_a_stalled_call_again_behind_a_longer_spin(fake_card, capsys):
    stalled = WARMUP + REPS  # the first call behind a spin
    card = fake_card(lambda card, i: 5.0 if i == stalled else 0.1)
    device, wall = cs.timed(card.fn, CYCLES_PER_MS, reps=REPS, warmup=WARMUP)
    assert device == pytest.approx(DEVICE_MS) and wall == pytest.approx(0.1)
    assert card.calls == WARMUP + 2 * REPS + 1
    # the stalled call outlasted its 1.3 ms spin; the rest wait 2 x 5 + 1 ms
    assert card.sleeps_ms == pytest.approx([1.3] + [11.0] * REPS, abs=CYCLE_MS)
    out = capsys.readouterr().out
    assert f"1 of {REPS + 1} timed calls were measured again" in out and "up to 5.0 ms" in out


def test_timed_raises_after_more_repeats_than_reps(fake_card):
    # a host that always takes 1 ms longer to enqueue than the device's last spin
    card = fake_card(lambda card, i: (card.sleeps_ms[-1] if card.sleeps_ms else 0.0) + 1.0)
    with pytest.raises(AssertionError, match=f"enqueued for longer than the device waited in {REPS + 1} calls"):
        cs.timed(card.fn, CYCLES_PER_MS, reps=REPS, warmup=WARMUP)
    assert card.calls == WARMUP + REPS + REPS + 1
    assert len(card.sleeps_ms) == REPS + 1
    assert all(b > a for a, b in zip(card.sleeps_ms, card.sleeps_ms[1:]))  # each repeat waits longer


def test_profile_kernels_leaves_user_annotations_out(monkeypatch, capsys):
    """A ``record_function`` range (``Optimizer.step#Adam.step``) carries device time on the card's
    timeline that spans kernels already counted: the kernel sums leave it out."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    steps = 4

    def row(key, device_type, us, count, annotation=False):
        return types.SimpleNamespace(key=key, device_type=device_type, self_device_time_total=us * steps, count=count * steps, is_user_annotation=annotation)

    rows = [row("multi_tensor_apply_kernel", cuda, 150.0, 8), row("Optimizer.step#Adam.step", cuda, 1100.0, 1, annotation=True),
            row("indexSelectLargeIndex", cuda, 100.0, 26), row("aten::embedding", cpu, 0.0, 26), row("idle kernel", cuda, 0.0, 1)]

    class FakeProfile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return rows

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    calls = []
    kernels = cs.profile_kernels(lambda: calls.append(1), steps=steps)
    assert len(calls) == 1 + steps
    assert kernels == {"multi_tensor_apply_kernel": (0.15, 8), "indexSelectLargeIndex": (0.1, 26)}
    assert cs.kernel_breakdown("fake", lambda: None, steps=steps) == pytest.approx(0.25)
    assert "Adam (foreach kernels)" in capsys.readouterr().out
