"""Revisioned watch cache over the cluster store's event feed.

Every store mutation is appended to a bounded in-memory event log keyed
by the store's monotonically increasing resource version, and a watch
opened at resourceVersion=R first replays every logged event with
rv > R, then streams live: the List+Watch contract a reflector depends
on.

If R has already been compacted out of the log the watch fails with
``TooOldResourceVersion`` and the client must relist, exactly like etcd's
"required revision has been compacted" → reflector relist path.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, List, Optional

from kubernetes_tpu_torch.apiserver.store import ClusterStore, Event


class TooOldResourceVersion(Exception):
    """The requested resourceVersion predates the log window (etcd
    ErrCompacted → client must List again and watch from the new RV)."""


class CachedEvent:
    __slots__ = ("rv", "event")

    def __init__(self, rv: int, event: Event):
        self.rv = rv
        self.event = event


class WatchCache:
    """Bounded event log + live fan-out. One per cluster store."""

    def __init__(self, store: ClusterStore, capacity: int = 100_000):
        self._store = store
        self._capacity = capacity
        self._log: deque[CachedEvent] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._live: List[Callable[[int, Event], None]] = []
        # subscribe to the store; events carry the object's already-bumped
        # resourceVersion (DELETED events reuse the store's current rv)
        self._handle = store.watch(self._on_events)

    # -- ingestion -----------------------------------------------------
    def _rv_of(self, event: Event) -> int:
        rv = getattr(event.obj.metadata, "resource_version", "") or "0"
        try:
            return int(rv)
        except ValueError:
            return 0

    def _on_events(self, events: List[Event]) -> None:
        """One store batch: logged in order, then fanned out."""
        cached = [CachedEvent(self._rv_of(e), e) for e in events]
        with self._lock:
            self._log.extend(cached)
            sinks = list(self._live)
        for ce in cached:
            for fn in sinks:
                fn(ce.rv, ce.event)

    # -- watch API -----------------------------------------------------
    def oldest_rv(self) -> Optional[int]:
        with self._lock:
            return self._log[0].rv if self._log else None

    def latest_rv(self) -> int:
        with self._lock:
            return self._log[-1].rv if self._log else 0

    def watch_from(
        self, resource_version: int, fn: Callable[[int, Event], None]
    ) -> "WatchCacheHandle":
        """Replay logged events with rv > resource_version, then attach
        live. Replay and attach happen under one lock acquisition so no
        event is missed or duplicated at the seam."""
        with self._lock:
            if self._log:
                oldest = self._log[0].rv
                # a client at rv < oldest-1 may have missed compacted events
                if resource_version < oldest - 1:
                    raise TooOldResourceVersion(
                        f"resourceVersion {resource_version} is too old "
                        f"(oldest logged: {oldest})"
                    )
                replay = [ce for ce in self._log if ce.rv > resource_version]
            else:
                replay = []
            # dispatch replay before any new live event can interleave
            for ce in replay:
                fn(ce.rv, ce.event)
            self._live.append(fn)
            return WatchCacheHandle(self, fn)

    def _remove(self, fn) -> None:
        with self._lock:
            if fn in self._live:
                self._live.remove(fn)

    def compact(self, keep_last: int) -> None:
        """Drop all but the newest keep_last events (etcd compaction)."""
        with self._lock:
            while len(self._log) > keep_last:
                self._log.popleft()

    def stop(self) -> None:
        self._handle.stop()


class WatchCacheHandle:
    def __init__(self, cache: WatchCache, fn):
        self._cache = cache
        self._fn = fn

    def stop(self) -> None:
        self._cache._remove(self._fn)
