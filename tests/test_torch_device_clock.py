"""The timeline's card clock (``native/timeline.DeviceClock``) on a fake
card whose events keep CUDA's float32 millisecond ``elapsed_time``.

Read from one fixed reference, a stamp late in a run would step by
milliseconds and a 3 us wire would read 0 or 1 ms: the clock moves its
reference up to the stamps it reads, so the wire reads 3 us at any hour.
"""

import time

import numpy as np
import pytest
import torch

from horovod_tpu_torch.native import timeline


class FakeEvent:
    """A timing CUDA event on a card whose clock reads ``FakeEvent.now``
    (ms, f64); ``elapsed_time`` rounds to float32 as CUDA's does."""
    now = 0.0

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self, stream=None):
        self.t = FakeEvent.now

    def synchronize(self):
        pass

    def query(self):
        return True

    def elapsed_time(self, end):
        return float(np.float32(end.t - self.t))


@pytest.mark.parametrize("hours", [0.01, 3.0])
def test_a_short_wire_keeps_its_microseconds_late_in_a_run(monkeypatch,
                                                           hours):
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    FakeEvent.now = 0.0
    host0 = time.perf_counter()
    clock = timeline.DeviceClock(None)
    for k in range(1, 4):
        FakeEvent.now = hours * 3.6e6 * k / 3 + 0.123
        start = clock.stamp(None)
        FakeEvent.now += 0.003
        end = clock.stamp(None)
        t0, t1 = start.seconds(), end.seconds()
        assert (t1 - t0) * 1e6 == pytest.approx(3.0, abs=0.01)
        assert t0 - host0 == pytest.approx(FakeEvent.now / 1e3, abs=2e-3)
