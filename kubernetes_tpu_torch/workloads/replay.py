"""Open-loop trace replay against the in-process store, and the quiesce
accounting.

- arrival: pods are created on the trace's clock by
  ``harness.burst.stream_arrivals`` on the engine's own thread; nothing
  waits for binds, so a slow scheduler faces a growing backlog;
- lifetime churn: a bound pod whose lifetime has run out is deleted
  (``delete_pods``, in bulk), so capacity recycles;
- latency from arrival: each pod is stamped when sent and its bind is
  seen on the engine's own watch, so arrival -> bind is what the
  submitter sees;
- at the end every injected pod is bound, pending, expired or deleted
  after its bind; any other is lost.
"""

from __future__ import annotations

import heapq
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.harness.burst import (
    create_chunk,
    sample_percentile,
    stream_arrivals,
)
from kubernetes_tpu_torch.workloads.trace import (
    Trace,
    TraceEvent,
    events_to_pods,
)


@dataclass
class ReplayStats:
    """What a replay run reports."""

    family: str
    injected: int
    expected: int            # trace size; injected < expected: faults
    ever_bound: int
    bound_at_end: int
    pending_at_end: int
    expired: int
    preempted: int           # deleted after its bind, not by expiry
    lost: int
    offered_rate: float      # arrivals a second actually offered
    duration_s: float        # injection start to the end of the run
    arrival_to_bind: Dict[str, float]   # count, p50, p90, p99, max (s)
    last_bind_s: float = 0.0            # offset of the last bind seen
    lost_names: List[str] = field(default_factory=list)
    send_errors: List[str] = field(default_factory=list)

    def latency_p99_ms(self) -> float:
        return self.arrival_to_bind.get("p99", 0.0) * 1000


class ReplayEngine:
    """One replay of ``trace`` against ``store``::

        eng = ReplayEngine(store, trace)
        eng.start()            # watch, then the injector and expirer
        ... the caller pumps its scheduler until quiet ...
        stats = eng.finish()   # stop the threads, account every pod

    ``time_scale`` stretches the trace clock (0: everything at once);
    ``expire`` turns lifetime churn on."""

    def __init__(self, store, trace: Trace, *, time_scale: float = 1.0,
                 expire: bool = True, chunk: int = 256,
                 flush_window: float = 0.02,
                 progress: Optional[Callable[[str], None]] = None):
        self.store = store
        self.trace = trace
        self.time_scale = time_scale
        self.expire = expire
        self.chunk = chunk
        self.flush_window = flush_window
        self.progress = progress
        self._events: Dict[str, TraceEvent] = {
            e.name: e for e in trace.events}
        self._lock = threading.Lock()
        self._arrival: Dict[str, float] = {}
        self._bind: Dict[str, Tuple[float, str]] = {}   # name -> (t, node)
        self._deleted: Dict[str, str] = {}   # name -> "expired" | "other"
        self._expiry_heap: List[Tuple[float, str]] = []
        self._expired_sent: set = set()
        self._stop = threading.Event()
        self.injection_done = threading.Event()
        self._t0: Optional[float] = None
        self._watch_handle = None
        self._threads: List[threading.Thread] = []
        self._send_errors: List[str] = []

    def start(self) -> None:
        self._t0 = time.monotonic()
        # watch before injecting, so no bind goes unseen
        self._watch_handle = self.store.watch(self._on_events)
        threads = [("replay-inject", self._inject)]
        if self.expire:
            threads.append(("replay-expire", self._expirer))
        for name, target in threads:
            t = threading.Thread(target=target, daemon=True, name=name)
            t.start()
            self._threads.append(t)

    def finish(self) -> ReplayStats:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        if self._watch_handle is not None:
            self._watch_handle.stop()
            self._watch_handle = None
        return self._collect()

    def _inject(self) -> None:
        try:
            n = stream_arrivals(
                ((e.t, e) for e in self.trace.events),
                lambda events: create_chunk(self.store,
                                            events_to_pods(events)),
                chunk=self.chunk, time_scale=self.time_scale,
                flush_window=self.flush_window, stop=self._stop,
                on_sent=self._note_sent)
            if self.progress:
                self.progress(f"replay: {n} arrivals injected")
        except Exception as e:  # noqa: BLE001 — reported in the stats
            self._send_errors.append(f"{type(e).__name__}: {e}")
        finally:
            self.injection_done.set()

    def _note_sent(self, event: TraceEvent, offset_s: float) -> None:
        with self._lock:
            self._arrival[event.name] = offset_s

    def _expirer(self) -> None:
        while not self._stop.is_set():
            now = time.monotonic()
            due: List[str] = []
            with self._lock:
                while self._expiry_heap and self._expiry_heap[0][0] <= now:
                    _, name = heapq.heappop(self._expiry_heap)
                    if name not in self._deleted:
                        due.append(name)
                        self._expired_sent.add(name)
            for lo in range(0, len(due), self.chunk):
                self.store.delete_pods([(self._events[n].namespace, n)
                                        for n in due[lo:lo + self.chunk]])
            self._stop.wait(0.05)

    def _on_events(self, events) -> None:
        now = time.monotonic()
        with self._lock:
            for e in events:
                if e.kind != "Pod":
                    continue
                name = e.obj.metadata.name
                ev = self._events.get(name)
                if ev is None:
                    continue
                if e.type == "DELETED":
                    self._deleted.setdefault(
                        name, "expired" if name in self._expired_sent
                        else "other")
                    continue
                if e.obj.spec.node_name and name not in self._bind:
                    self._bind[name] = (now - self._t0, e.obj.spec.node_name)
                    if self.expire and ev.lifetime_s is not None:
                        scale = self.time_scale if self.time_scale > 0 \
                            else 1.0
                        heapq.heappush(self._expiry_heap,
                                       (now + ev.lifetime_s * scale, name))

    def _collect(self) -> ReplayStats:
        duration = time.monotonic() - self._t0 if self._t0 else 0.0
        live = {p.metadata.name: p for p in self.store.list_pods()
                if p.metadata.name in self._events}
        with self._lock:
            arrival = dict(self._arrival)
            bind = dict(self._bind)
            deleted = dict(self._deleted)
            expired_intent = set(self._expired_sent)
        # a delete the engine sent counts as expired even when its event
        # is still on the way
        expired = {n for n in arrival if n not in live
                   and (n in expired_intent or deleted.get(n) == "expired")}
        preempted = [n for n in arrival
                     if n not in live and n not in expired and n in bind]
        lost = [n for n in arrival
                if n not in live and n not in expired and n not in bind]
        lat = [max(0.0, t_bind - arrival[n])
               for n, (t_bind, _) in bind.items() if n in arrival]
        stats = ReplayStats(
            family=self.trace.family,
            injected=len(arrival),
            expected=len(self.trace.events),
            ever_bound=len(bind),
            bound_at_end=sum(1 for p in live.values() if p.spec.node_name),
            pending_at_end=sum(1 for p in live.values()
                               if not p.spec.node_name),
            expired=len(expired),
            preempted=len(preempted),
            lost=len(lost),
            offered_rate=(
                len(arrival) / (self.trace.duration_s * self.time_scale)
                if self.time_scale > 0 and self.trace.duration_s > 0
                else 0.0),
            duration_s=duration,
            arrival_to_bind={
                "count": len(lat),
                "p50": sample_percentile(lat, 0.50),
                "p90": sample_percentile(lat, 0.90),
                "p99": sample_percentile(lat, 0.99),
                "max": max(lat) if lat else 0.0,
            },
            last_bind_s=max((t for t, _ in bind.values()), default=0.0),
            lost_names=sorted(lost)[:20],
        )
        stats.send_errors = list(self._send_errors)
        return stats
