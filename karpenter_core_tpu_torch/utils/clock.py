"""Clock abstraction: real and fake (test) clocks.

A copy of ``karpenter_core_tpu/utils/clock.py``.  All timing policy (the
tenant plane's session TTL, breaker windows and bucket refills) goes through
a Clock so suites can advance time deterministically.  The reference's
``clock.skew`` chaos point is not ported (the chaos plane is not).
"""

from __future__ import annotations

import threading
import time as _time


class Clock:
    def now(self) -> float:
        return _time.time()

    def sleep(self, seconds: float) -> None:
        _time.sleep(seconds)


class FakeClock(Clock):
    def __init__(self, start: float = 1_000_000.0) -> None:
        self._now = start
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._now

    def sleep(self, seconds: float) -> None:
        self.step(seconds)

    def step(self, seconds: float) -> None:
        with self._lock:
            self._now += seconds

    def set_time(self, t: float) -> None:
        with self._lock:
            self._now = t
