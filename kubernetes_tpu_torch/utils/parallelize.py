"""Chunked fan-out over a thread pool (upstream
``internal/parallelize``): ``parallelism`` workers, chunks of
``max(1, min(sqrt(n), n // parallelism + 1))`` indices. With
``parallelism=1`` (or one index) the indices run in order on the calling
thread, so callers see exactly the sequential loop. The serial path's
Filter and Score fan out through it; the work holds the interpreter lock,
so more workers change the order results arrive in, not the time."""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

DEFAULT_PARALLELISM = 16


class Parallelizer:
    def __init__(self, parallelism: int = DEFAULT_PARALLELISM):
        self.parallelism = max(1, parallelism)
        self._pool: Optional[ThreadPoolExecutor] = None

    def _ensure_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.parallelism,
                thread_name_prefix="parallelize")
        return self._pool

    def shutdown(self) -> None:
        """Let the pool's threads go; a later ``until`` starts a new
        pool."""
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    def chunk_size(self, n: int) -> int:
        return max(1, min(int(math.sqrt(n)), n // self.parallelism + 1))

    def until(self, n: int, fn: Callable[[int], None],
              stop_check: Optional[Callable[[], bool]] = None) -> None:
        """``fn(i)`` for each i in [0, n); ``stop_check()``, tested before
        each index, ends the work early once it returns True."""
        if n <= 0:
            return
        if self.parallelism == 1 or n == 1:
            for i in range(n):
                if stop_check is not None and stop_check():
                    return
                fn(i)
            return
        chunk = self.chunk_size(n)
        pool = self._ensure_pool()

        def run_chunk(start: int) -> None:
            for i in range(start, min(start + chunk, n)):
                if stop_check is not None and stop_check():
                    return
                fn(i)

        for f in [pool.submit(run_chunk, s) for s in range(0, n, chunk)]:
            f.result()
