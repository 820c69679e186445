"""Open-loop arrival injection: the loop that sends items on a clock
(nothing waits for binds), the bulk admission of one chunk of pods, and
the exact-sample percentile the replay engine reports."""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

from kubernetes_tpu_torch.api.types import Pod


def sample_percentile(samples: Sequence[float], q: float) -> float:
    """The sample at index ``int(len * q)`` of the sorted samples
    (clamped; 0 when empty)."""
    if not samples:
        return 0.0
    s = sorted(samples)
    return s[min(int(len(s) * q), len(s) - 1)]


def create_chunk(store, pods: Sequence[Pod]) -> None:
    """Admit one chunk of pods in one store call."""
    store.create_pods(list(pods))


def stream_arrivals(
    arrivals,
    send: Callable[[List], None],
    *,
    chunk: int = 512,
    time_scale: float = 1.0,
    flush_window: float = 0.0,
    clock: Callable[[], float] = time.monotonic,
    stop=None,
    on_sent: Optional[Callable[[object, float], None]] = None,
) -> int:
    """Send ``(due_s, item)`` pairs, ordered by ``due_s``, when they fall
    due, in chunks of at most ``chunk``: an item is sent once its time
    has come, whatever became of earlier ones. ``time_scale`` stretches
    the clock (0 sends everything at once); items due within
    ``flush_window`` ride the same send; ``on_sent(item, offset_s)``
    stamps each item with its real send offset; ``stop`` (an Event)
    aborts between sends. Returns the items sent."""
    t0 = clock()
    sent = 0
    batch: List = []

    def flush() -> None:
        nonlocal sent, batch
        while batch:
            part, batch = batch[:chunk], batch[chunk:]
            send(part)
            now_off = clock() - t0
            if on_sent is not None:
                for item in part:
                    on_sent(item, now_off)
            sent += len(part)

    for due_s, item in arrivals:
        if stop is not None and stop.is_set():
            break
        due = due_s * time_scale
        while True:
            wait = due - (clock() - t0) - flush_window
            if wait <= 0:
                break
            if batch:
                flush()
            if stop is not None and stop.is_set():
                return sent
            time.sleep(min(wait, 0.05))
        batch.append(item)
        if len(batch) >= chunk:
            flush()
    flush()
    return sent
