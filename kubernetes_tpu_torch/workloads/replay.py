"""Open-loop trace replay against the in-process store, and the quiesce
accounting.

- arrival: pods are created on the trace's clock by
  ``harness.burst.stream_arrivals`` on the engine's own thread; nothing
  waits for binds, so a slow scheduler faces a growing backlog;
- lifetime churn: a bound pod whose lifetime has run out is deleted
  (``delete_pods``, in bulk), so capacity recycles;
- latency from arrival: each pod is stamped when sent and its bind is
  seen on the engine's own watch, so arrival -> bind is what the
  submitter sees, overall and by the events' workload class;
- tenants: with ``tenant_targets`` each tenant's arrivals and expiries
  go through its own client (its own flow under APF);
- at the end every injected pod is bound, pending, expired or deleted
  after its bind; any other is lost;
- gangs: a gang with some but not all members ever bound is partial;
  a pending pod that would fit by evicting only lower-priority pods is
  a priority inversion (a gang counts only if all its pending members
  fit together).

The target is anything with the store's surface (``create_pods``,
``delete_pods``, ``list_pods``, ``list_nodes``, ``watch``): the
in-process store, a ``RestClusterClient`` (creates as ``PodList``
POSTs), or ``federation.FederatedClusterClient``, which routes the
creates across clusters and fans the watch in from every cell.
"""

from __future__ import annotations

import heapq
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from kubernetes_tpu_torch.harness.burst import (
    create_chunk,
    sample_percentile,
    stream_arrivals,
)
from kubernetes_tpu_torch.scheduler.framework.plugins.mesh_locality import (
    node_coord,
)
from kubernetes_tpu_torch.scheduler.types import (
    Resource,
    compute_pod_resource_request,
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
    # class ("all" and each event class) -> count, p50, p90, p99, max (s)
    arrival_to_bind: Dict[str, Dict[str, float]]
    gangs_total: int = 0
    gangs_placed: int = 0
    gangs_partial: int = 0   # some but not all members ever bound
    mean_gang_adjacency: Optional[float] = None
    priority_inversions: int = 0
    last_bind_s: float = 0.0            # offset of the last bind seen
    lost_names: List[str] = field(default_factory=list)
    send_errors: List[str] = field(default_factory=list)

    @property
    def gangs_intact(self) -> bool:
        return self.gangs_partial == 0

    def latency_p99_ms(self, cls: str = "all") -> float:
        return self.arrival_to_bind.get(cls, {}).get("p99", 0.0) * 1000


class ReplayEngine:
    """One replay of ``trace`` against ``store``::

        eng = ReplayEngine(store, trace)
        eng.start()            # watch, then the injector and expirer
        ... the caller pumps its scheduler until quiet ...
        stats = eng.finish()   # stop the threads, account every pod

    ``time_scale`` stretches the trace clock (0: everything at once);
    ``expire`` turns lifetime churn on; ``tenant_targets`` maps a tenant
    to the client its pods are created and deleted through (the others
    go through ``store``)."""

    def __init__(self, store, trace: Trace, *, time_scale: float = 1.0,
                 expire: bool = True, chunk: int = 256,
                 flush_window: float = 0.02,
                 tenant_targets: Optional[Dict[str, object]] = None,
                 progress: Optional[Callable[[str], None]] = None):
        self.store = store
        self.tenant_targets = tenant_targets or {}
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

    def due_expiries(self) -> int:
        """Bound pods whose lifetime has run out but whose delete is not
        sent yet: what a caller waiting for quiet must wait for."""
        now = time.monotonic()
        with self._lock:
            return sum(1 for t, _ in self._expiry_heap if t <= now)

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
                self._send_chunk, chunk=self.chunk, time_scale=self.time_scale,
                flush_window=self.flush_window, stop=self._stop,
                on_sent=self._note_sent)
            if self.progress:
                self.progress(f"replay: {n} arrivals injected")
        except Exception as e:  # noqa: BLE001 — reported in the stats
            self._send_errors.append(f"{type(e).__name__}: {e}")
        finally:
            self.injection_done.set()

    def _target_for(self, tenant: str):
        return self.tenant_targets.get(tenant, self.store)

    def _send_chunk(self, events: List[TraceEvent]) -> None:
        if not self.tenant_targets:
            create_chunk(self.store, events_to_pods(events))
            return
        by_tenant: Dict[str, List[TraceEvent]] = {}
        for e in events:
            by_tenant.setdefault(e.tenant, []).append(e)
        for tenant, evs in by_tenant.items():
            create_chunk(self._target_for(tenant), events_to_pods(evs))

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
            by_tenant: Dict[str, List[str]] = {}
            for n in due:
                by_tenant.setdefault(self._events[n].tenant, []).append(n)
            for tenant, names in by_tenant.items():
                target = self._target_for(tenant)
                for lo in range(0, len(names), self.chunk):
                    part = names[lo:lo + self.chunk]
                    try:
                        target.delete_pods([(self._events[n].namespace, n)
                                            for n in part])
                    except Exception:  # noqa: BLE001 — one pod already
                        # gone (preempted, or a cell lost under a
                        # federation): the rest expire one by one
                        for n in part:
                            try:
                                target.delete_pod(self._events[n].namespace,
                                                  n)
                            except Exception:  # noqa: BLE001
                                pass
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
        lat: Dict[str, List[float]] = {"all": []}
        for n, (t_bind, _) in bind.items():
            if n not in arrival:
                continue
            d = max(0.0, t_bind - arrival[n])
            lat["all"].append(d)
            cls = self._events[n].cls
            if cls:
                lat.setdefault(cls, []).append(d)
        gangs = self._gang_integrity(bind)
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
                cls: {"count": len(vals),
                      "p50": sample_percentile(vals, 0.50),
                      "p90": sample_percentile(vals, 0.90),
                      "p99": sample_percentile(vals, 0.99),
                      "max": max(vals) if vals else 0.0}
                for cls, vals in lat.items()},
            gangs_total=gangs[0],
            gangs_placed=gangs[1],
            gangs_partial=gangs[2],
            mean_gang_adjacency=self._adjacency(bind),
            priority_inversions=self._priority_inversions(live),
            last_bind_s=max((t for t, _ in bind.values()), default=0.0),
            lost_names=sorted(lost)[:20],
        )
        stats.send_errors = list(self._send_errors)
        return stats

    def _gang_integrity(self, bind: Dict) -> Tuple[int, int, int]:
        """(gangs, gangs with every member bound, gangs with some but not
        all bound) over the trace's gangs of more than one pod."""
        members: Dict[str, List[str]] = {}
        size: Dict[str, int] = {}
        for e in self.trace.events:
            if e.gang and e.gang_size > 1:
                members.setdefault(e.gang, []).append(e.name)
                size[e.gang] = e.gang_size
        placed = partial = 0
        for gang, names in members.items():
            n_bound = sum(1 for n in names if n in bind)
            if n_bound == 0:
                continue
            if n_bound >= size[gang]:
                placed += 1
            else:
                partial += 1
        return len(members), placed, partial

    def _adjacency(self, bind: Dict) -> Optional[float]:
        """The mean over gangs of the mean pairwise Manhattan distance
        between their members' nodes on the device mesh; None when no
        gang member landed on a node with mesh coordinates."""
        coords = {}
        for node in self.store.list_nodes():
            c = node_coord(node)
            if c is not None:
                coords[node.metadata.name] = c
        if not coords:
            return None
        members: Dict[str, List[Tuple[int, int]]] = {}
        for e in self.trace.events:
            hit = bind.get(e.name) if e.gang else None
            c = coords.get(hit[1]) if hit is not None else None
            if c is not None:
                members.setdefault(e.gang, []).append(c)
        dists = []
        for pts in members.values():
            if len(pts) < 2:
                continue
            acc = cnt = 0
            for i in range(len(pts)):
                for j in range(i + 1, len(pts)):
                    acc += (abs(pts[i][0] - pts[j][0])
                            + abs(pts[i][1] - pts[j][1]))
                    cnt += 1
            dists.append(acc / cnt)
        return (sum(dists) / len(dists)) if dists else None

    def _priority_inversions(self, live: Dict) -> int:
        """Pending pods that would fit on some node after evicting only
        pods of strictly lower priority (cpu and memory only). A gang's
        pending members count only when all of them fit together, by
        first-fit-decreasing into that headroom."""
        nodes = list(self.store.list_nodes())
        if not nodes:
            return 0
        name_idx = {n.metadata.name: i for i, n in enumerate(nodes)}
        alloc = np.zeros((len(nodes), 2), dtype=np.int64)
        for i, n in enumerate(nodes):
            r = Resource.from_resource_list(n.status.allocatable)
            alloc[i] = (r.milli_cpu, r.memory)
        used = np.zeros((len(nodes), 2), dtype=np.int64)
        by_prio: Dict[int, np.ndarray] = {}
        for pod in self.store.list_pods():
            node_i = name_idx.get(pod.spec.node_name or "")
            if node_i is None:
                continue
            req = compute_pod_resource_request(pod)
            row = np.array([req.milli_cpu, req.memory], dtype=np.int64)
            used[node_i] += row
            p = pod.priority()
            if p not in by_prio:
                by_prio[p] = np.zeros((len(nodes), 2), dtype=np.int64)
            by_prio[p][node_i] += row
        free = alloc - used

        def headroom_below(prio: int) -> np.ndarray:
            h = free.copy()
            for p, rows in by_prio.items():
                if p < prio:
                    h += rows
            return h

        inversions = 0
        gangs_seen: Dict[str, List] = {}
        for pod in (p for p in live.values() if not p.spec.node_name):
            ev = self._events.get(pod.metadata.name)
            if ev is not None and ev.gang and ev.gang_size > 1:
                gangs_seen.setdefault(ev.gang, []).append(pod)
                continue
            req = compute_pod_resource_request(pod)
            need = np.array([req.milli_cpu, req.memory], dtype=np.int64)
            if np.any(np.all(headroom_below(pod.priority()) >= need,
                             axis=1)):
                inversions += 1
        with self._lock:
            bound = set(self._bind)
        for gang, pods in gangs_seen.items():
            size = self._events[pods[0].metadata.name].gang_size
            pending = {p.metadata.name for p in pods}
            bound_members = sum(
                1 for e in self.trace.events
                if e.gang == gang and e.name not in pending
                and e.name in bound)
            if bound_members + len(pods) < size:
                continue   # members missing: not placeable
            h = headroom_below(max(p.priority() for p in pods))
            ok = True
            for r in sorted((compute_pod_resource_request(p) for p in pods),
                            key=lambda r: -r.milli_cpu):
                need = np.array([r.milli_cpu, r.memory], dtype=np.int64)
                fits = np.nonzero(np.all(h >= need, axis=1))[0]
                if fits.size == 0:
                    ok = False
                    break
                h[fits[0]] -= need
            if ok:
                inversions += len(pods)
        return inversions
