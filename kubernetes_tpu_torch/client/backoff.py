"""Client-side resilience primitives: jittered exponential backoff, a
per-client retry budget, and a circuit breaker.

Behavioral equivalents of the reference client-go stack the scheduler
depends on to survive an unhealthy apiserver:

- ``Backoff`` — ``k8s.io/apimachinery/pkg/util/wait.Backoff`` (duration,
  factor, jitter, cap): each step multiplies the base delay and smears
  it by ±jitter so a fleet of clients whose connections dropped together
  does not reconnect in lockstep (the thundering-herd relist storm the
  reference's ``JitterUntil`` exists to prevent). Deterministic under a
  caller-supplied seeded RNG so chaos runs replay exactly.
- ``RetryBudget`` — client-go's ``flowcontrol.Backoff`` + the sidecar
  retry-budget idea: a token bucket spent per retry (never per first
  attempt) and refilled over time, so a dying server costs each client a
  bounded amount of extra load instead of retries-squared.
- ``CircuitBreaker`` — consecutive-failure trip wire with listener
  callbacks; the scheduler wires it to degraded mode (pause binding,
  requeue, resume on recovery) the way the reference's leader election
  demotes a scheduler that lost its apiserver.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Iterator, Optional, Tuple

__all__ = ["Backoff", "RetryBudget", "CircuitBreaker", "retry_call"]


class Backoff:
    """Exponential backoff with bounded jitter.

    ``delay(attempt)`` for attempt n (0-based) is
    ``min(base * factor**n, cap)`` smeared to ``d * (1 ± jitter)`` —
    always >= 0, and with ``jitter < 1`` always > 0. ``steps()`` yields
    successive delays statefully.
    """

    def __init__(self, base: float = 0.05, factor: float = 2.0,
                 cap: float = 5.0, jitter: float = 0.4,
                 rng: Optional[random.Random] = None):
        if not 0.0 <= jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {jitter}")
        self.base = float(base)
        self.factor = float(factor)
        self.cap = float(cap)
        self.jitter = float(jitter)
        self._rng = rng if rng is not None else random.Random()

    def delay(self, attempt: int) -> float:
        d = min(self.base * (self.factor ** max(0, attempt)), self.cap)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return d

    def steps(self) -> Iterator[float]:
        attempt = 0
        while True:
            yield self.delay(attempt)
            attempt += 1


class RetryBudget:
    """Token bucket spent once per RETRY. When empty, the caller must
    surface the original error instead of sleeping again — a misbehaving
    server can slow a client down but never stall it unboundedly."""

    def __init__(self, budget: float = 10.0, refill_per_second: float = 1.0):
        self.capacity = float(budget)
        self.refill = float(refill_per_second)
        self._tokens = self.capacity
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def try_spend(self, n: float = 1.0) -> bool:
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self.capacity,
                               self._tokens + (now - self._last) * self.refill)
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def remaining(self) -> float:
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self.capacity,
                               self._tokens + (now - self._last) * self.refill)
            self._last = now
            return self._tokens


class CircuitBreaker:
    """Consecutive-failure breaker with open/close notifications.

    ``record_failure()`` trips the breaker after ``failure_threshold``
    consecutive failures; ``record_success()`` closes it immediately
    (requests themselves are the half-open probes — the retry loop keeps
    attempting, so a recovered server closes the circuit on its first
    served request). The listener runs OUTSIDE the lock with the new
    state; it must be idempotent."""

    def __init__(self, failure_threshold: int = 5,
                 listener: Optional[Callable[[bool], None]] = None):
        self.failure_threshold = int(failure_threshold)
        self._failures = 0
        self._open = False
        self._lock = threading.Lock()
        self._listener = listener

    @property
    def is_open(self) -> bool:
        with self._lock:
            return self._open

    def set_listener(self, listener: Optional[Callable[[bool], None]],
                     replay: bool = True) -> None:
        """Install ``listener(open: bool)``; with ``replay`` the current
        state is delivered immediately so a late subscriber (a scheduler
        started after the first outage) does not miss an open circuit."""
        with self._lock:
            self._listener = listener
            state = self._open
        if replay and listener is not None:
            listener(state)

    def _notify(self, state: bool) -> None:
        listener = self._listener
        if listener is not None:
            try:
                listener(state)
            except Exception:  # noqa: BLE001 — a bad listener must not
                pass           # poison the transport path

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            tripped = (not self._open
                       and self._failures >= self.failure_threshold)
            if tripped:
                self._open = True
        if tripped:
            self._notify(True)

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            recovered = self._open
            self._open = False
        if recovered:
            self._notify(False)


def retry_call(
    fn: Callable[[], object],
    retryable: Tuple[type, ...] = (OSError,),
    backoff: Optional[Backoff] = None,
    budget: Optional[RetryBudget] = None,
    max_attempts: int = 4,
    sleep: Callable[[float], None] = time.sleep,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
):
    """Call ``fn`` with jittered-backoff retries. Exhausting
    ``max_attempts`` or the ``budget`` re-raises the ORIGINAL error
    (never a synthetic wrapper — callers dispatch on error type)."""
    backoff = backoff or Backoff()
    for attempt in range(max_attempts):
        try:
            return fn()
        except retryable as err:
            last = attempt == max_attempts - 1
            if last or (budget is not None and not budget.try_spend()):
                raise
            if on_retry is not None:
                on_retry(attempt, err)
            sleep(backoff.delay(attempt))
    raise RuntimeError("unreachable")
