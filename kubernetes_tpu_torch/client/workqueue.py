"""Work queues (client-go's ``util/workqueue``): a FIFO with the
dirty/processing dedup protocol, a delaying queue and a rate-limited
one, which controllers use to decouple event delivery from
reconciliation: an item added many times while it is processed is
processed exactly once more."""

from __future__ import annotations

import heapq
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional


class WorkQueue:
    """``add`` of a queued (dirty) item does nothing; ``add`` of an item
    being processed marks it dirty, and ``done`` queues it once more;
    ``get`` blocks until an item, a timeout or shutdown."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: deque = deque()
        self._dirty: set = set()
        self._processing: set = set()
        self._shutting_down = False

    def add(self, item: Any) -> None:
        with self._cond:
            if self._shutting_down or item in self._dirty:
                return
            self._dirty.add(item)
            if item in self._processing:
                return
            self._queue.append(item)
            self._cond.notify()

    def get(self, timeout: Optional[float] = None) -> Optional[Any]:
        """The next item, or None on shutdown or timeout. Every item got
        is handed back with ``done``."""
        with self._cond:
            deadline = None if timeout is None else time.monotonic() + timeout
            while not self._queue and not self._shutting_down:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                self._cond.wait(remaining)
            if not self._queue:
                return None
            item = self._queue.popleft()
            self._processing.add(item)
            self._dirty.discard(item)
            return item

    def done(self, item: Any) -> None:
        with self._cond:
            self._processing.discard(item)
            if item in self._dirty:
                self._queue.append(item)
                self._cond.notify()

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue)

    def shutdown(self) -> None:
        with self._cond:
            self._shutting_down = True
            self._cond.notify_all()

    @property
    def shutting_down(self) -> bool:
        with self._lock:
            return self._shutting_down


class DelayingQueue(WorkQueue):
    """``add_after``: the item is added once its delay has passed (one
    waiter thread over a heap of due times, started on first use)."""

    def __init__(self):
        super().__init__()
        self._waiting: List[tuple] = []  # (due, seq, item)
        self._seq = 0
        self._waiting_cond = threading.Condition()
        self._waiter: Optional[threading.Thread] = None

    def add_after(self, item: Any, delay: float) -> None:
        if self.shutting_down:
            return
        if delay <= 0:
            self.add(item)
            return
        with self._waiting_cond:
            heapq.heappush(self._waiting,
                           (time.monotonic() + delay, self._seq, item))
            self._seq += 1
            if self._waiter is None:
                self._waiter = threading.Thread(
                    target=self._wait_loop, daemon=True,
                    name="delaying-queue")
                self._waiter.start()
            self._waiting_cond.notify()

    def _wait_loop(self) -> None:
        while not self.shutting_down:
            with self._waiting_cond:
                now = time.monotonic()
                while self._waiting and self._waiting[0][0] <= now:
                    self.add(heapq.heappop(self._waiting)[2])
                timeout = (self._waiting[0][0] - now) if self._waiting \
                    else 1.0
                self._waiting_cond.wait(timeout)

    def shutdown(self) -> None:
        super().shutdown()
        with self._waiting_cond:
            self._waiting_cond.notify_all()


class ItemExponentialFailureRateLimiter:
    """Per item: base * 2^failures seconds, capped."""

    def __init__(self, base_delay: float = 0.005, max_delay: float = 1000.0):
        self._base = base_delay
        self._max = max_delay
        self._failures: Dict[Any, int] = {}
        self._lock = threading.Lock()

    def when(self, item: Any) -> float:
        with self._lock:
            n = self._failures.get(item, 0)
            self._failures[item] = n + 1
            return min(self._base * (2 ** n), self._max)

    def forget(self, item: Any) -> None:
        with self._lock:
            self._failures.pop(item, None)

    def num_requeues(self, item: Any) -> int:
        with self._lock:
            return self._failures.get(item, 0)


class RateLimitingQueue(DelayingQueue):
    """A delaying queue whose ``add_rate_limited`` waits the rate
    limiter's delay for the item."""

    def __init__(self, rate_limiter: Optional[
            ItemExponentialFailureRateLimiter] = None):
        super().__init__()
        self.rate_limiter = rate_limiter or ItemExponentialFailureRateLimiter()

    def add_rate_limited(self, item: Any) -> None:
        self.add_after(item, self.rate_limiter.when(item))

    def forget(self, item: Any) -> None:
        self.rate_limiter.forget(item)

    def num_requeues(self, item: Any) -> int:
        return self.rate_limiter.num_requeues(item)
