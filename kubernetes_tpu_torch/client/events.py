"""EventRecorder: asynchronous, aggregating event recording (client-go
``tools/record``). A hot path enqueues and returns; a background thread
flushes the queue into the store, fresh Events in one bulk write.
Occurrences with the same object, type, reason and message aggregate into
one Event with a bumped ``count``. The queue is bounded: past
``queue_cap`` an event is dropped (``dropped`` counts them) rather than
blocking its caller.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional, Tuple

from kubernetes_tpu_torch.api.types import Event, ObjectMeta, object_reference

NORMAL = "Normal"
WARNING = "Warning"

_PRUNE_INTERVAL = 60.0


class EventRecorder:
    def __init__(self, client, component: str, queue_cap: int = 8192,
                 flush_interval: float = 0.2):
        self.client = client
        self.component = component
        self._queue: deque = deque()
        self._cap = queue_cap
        self._flush_interval = flush_interval
        self.dropped = 0
        # correlation cache: key -> Event name in the store
        self._correlated: dict = {}
        self._lock = threading.Lock()
        # serializes whole flush passes: external flush_now callers
        # (tests, shutdown) race the background loop otherwise, and
        # _write's correlation cache is not safe under two writers
        self._flush_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._seq = 0
        self._last_prune = 0.0
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def event(self, obj, event_type: str, reason: str, message: str) -> None:
        """Record an event against ``obj``. Non-blocking: enqueues for the
        flush thread, which takes the object reference (objects are
        replaced, not changed, after create)."""
        self._enqueue(obj, event_type, reason, message, ())

    def eventf(self, obj, event_type: str, reason: str,
               fmt: str, *args) -> None:
        """Like ``event``, with ``fmt % args`` formatted on the flush
        thread (one Scheduled event per bound pod on the commit path)."""
        self._enqueue(obj, event_type, reason, fmt, args)

    def _enqueue(self, obj, event_type, reason, fmt, args) -> None:
        with self._lock:
            if len(self._queue) >= self._cap:
                self.dropped += 1   # full channel: drop, never block
                return
            self._queue.append(
                (obj, event_type, reason, fmt, args, time.time())
            )
        self._wake.set()

    # ------------------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"events-{self.component}"
        )
        self._thread.start()

    def stop(self, flush: bool = True) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if flush:
            self.flush_now()

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self._flush_interval)
            self._wake.clear()
            try:
                with self._flush_lock:
                    self._flush_locked()
            except Exception:  # pragma: no cover — recording must never
                pass           # take down the component

    # ------------------------------------------------------------------
    def flush_now(self) -> int:
        """Drain the queue synchronously (tests and shutdown)."""
        with self._flush_lock:
            return self._flush_locked()

    def _flush_locked(self) -> int:
        """One flush pass: correlated occurrences update their existing
        Event; the fresh ones land in one bulk store write."""
        with self._lock:
            items = list(self._queue)
            self._queue.clear()
        fresh: list = []
        pending: dict = {}   # event name -> Event queued in THIS pass
        for obj, etype, reason, fmt, args, ts in items:
            message = fmt % args if args else fmt
            ev = self._build(object_reference(obj), etype, reason,
                             message, ts, pending)
            if ev is not None:
                fresh.append(ev)
        if fresh:
            self.client.create_events(fresh)
        now = time.time()
        if items and now - self._last_prune > _PRUNE_INTERVAL:
            self._last_prune = now
            self.client.prune_expired_events(now)
        return len(items)

    def _build(self, ref, etype: str, reason: str, message: str,
               ts: float, pending: dict) -> Optional[Event]:
        """Correlate or construct: returns the fresh Event to create
        (caller batches the write), or None when an existing Event —
        stored, or queued earlier in THIS pass (``pending``) — absorbed
        the occurrence."""
        # cluster-scoped objects have no namespace; their events live in
        # "default" — the SAME namespace for create and re-lookup, or
        # aggregation silently never hits
        ns = ref.namespace or "default"
        key: Tuple = (ref.kind, ns, ref.name, ref.uid, etype,
                      reason, message)
        name = self._correlated.get(key)
        if name is not None:
            queued = pending.get(name)
            if queued is not None:
                queued.count += 1
                queued.last_timestamp = ts
                return None
            existing = self.client.get_event(ns, name)
            if existing is not None and existing.involved_object.uid == ref.uid:
                existing.count += 1
                existing.last_timestamp = ts
                self.client.update_event(existing)
                return None
            del self._correlated[key]
        self._seq += 1
        name = f"{ref.name}.{int(ts * 1e6):x}.{self._seq:x}"
        ev = Event(
            metadata=ObjectMeta(name=name, namespace=ns),
            involved_object=ref,
            reason=reason,
            message=message,
            type=etype,
            count=1,
            first_timestamp=ts,
            last_timestamp=ts,
            source_component=self.component,
        )
        self._correlated[key] = name
        pending[name] = ev
        if len(self._correlated) > 4096:   # bounded correlation cache
            self._correlated.pop(next(iter(self._correlated)))
        return ev
