"""Clocks a caller can swap: ``RealClock`` reads the monotonic clock;
``FakeClock`` moves only when stepped (or slept on), so lease expiry and
backoff can be tested without waiting."""

from __future__ import annotations

import threading
import time


class RealClock:
    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


class FakeClock:
    def __init__(self, start: float = 0.0):
        self._now = start
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._now

    def step(self, seconds: float) -> None:
        with self._lock:
            self._now += seconds

    def sleep(self, seconds: float) -> None:
        self.step(seconds)
