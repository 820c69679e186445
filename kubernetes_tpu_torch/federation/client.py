"""Cross-cluster client: route, fan in and merge at cluster granularity.

A :class:`FederatedClusterClient` routes each create to the cluster the
federation scheduler chose, fans list and watch over every live cluster,
and remembers each pod's route so deletes and failover find it again.
The replay engine (and anything else that speaks the store's surface)
drives a whole federation as it drives one cluster.

- never lost: a unit no live cluster fits goes to its home cluster and
  pends there until its own scheduler binds it;
- gang continuity: the first chunk carrying a gang member decides the
  gang's cluster, and later members follow it, so a gang never
  straddles clusters;
- failover: ``failover_cluster(cid)`` creates unbound copies of the dead
  cell's pods (same names) on the survivors and stops only the dead
  cell's watch;
- degradation: while the federation scheduler is down (or raises), each
  pod routes to its namespace's home cluster and every cell keeps
  scheduling.
"""

from __future__ import annotations

import copy
import logging
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from kubernetes_tpu_torch.api.types import shallow_copy
from kubernetes_tpu_torch.federation.ledger import CapacityLedger
from kubernetes_tpu_torch.federation.scheduler import (
    GANG_NAME_LABEL,
    FederationScheduler,
    FederationUnavailable,
)
from kubernetes_tpu_torch.harness.burst import create_chunk
from kubernetes_tpu_torch.observability.tracer import get_tracer

_logger = logging.getLogger(__name__)


def elect_trace_uid(uids) -> Optional[str]:
    """The trace id every client elects alike: the first uid the tracer
    samples, or None when tracing is off or none is sampled. (The copy of
    ``client/restcluster.py::elect_trace_uid`` in the reference package;
    it moves there when the port has the REST client.)"""
    tracer = get_tracer()
    if not tracer.enabled:
        return None
    for u in uids:
        if u and tracer.sampled(u):
            return u
    return None


class HomeMap:
    """Namespace -> home cluster: crc32 over the registered clusters by
    default, rewritten by the ``ClusterRebalancer`` (``spread`` releases a
    namespace to free placement, ``overrides`` re-homes it)."""

    def __init__(self, clusters: Sequence[int],
                 pin: Optional[Dict[str, int]] = None):
        self._clusters = sorted(clusters)
        self.pin = dict(pin or {})
        self.spread: set = set()
        self.overrides: Dict[str, int] = {}

    def home_of(self, namespace: str) -> Optional[int]:
        ns = namespace or "default"
        if ns in self.spread:
            return None
        if ns in self.overrides:
            return self.overrides[ns]
        if ns in self.pin:
            return self.pin[ns]
        if not self._clusters:
            return None
        return self._clusters[zlib.crc32(ns.encode()) % len(self._clusters)]


def _unbound_copy(pod):
    """A copy with the bind cleared; the original is not touched."""
    p = shallow_copy(pod)
    p.spec = copy.copy(pod.spec)
    p.spec.node_name = ""
    return p


class _FederatedWatchHandle:
    """One ``stop`` over the per-cluster watch handles."""

    def __init__(self, client: "FederatedClusterClient", key: int):
        self._client = client
        self._key = key

    def stop(self) -> None:
        self._client._stop_watch_group(self._key)


class FederatedClusterClient:
    """A store-shaped client over K clusters. ``clusters`` maps a cluster
    id to its store (anything with the store's surface)."""

    def __init__(self, clusters: Dict[int, object],
                 scheduler: FederationScheduler, ledger: CapacityLedger,
                 home_map: Optional[HomeMap] = None):
        self.clusters = dict(clusters)
        self.scheduler = scheduler
        self.ledger = ledger
        self.home_map = home_map or HomeMap(sorted(self.clusters))
        for cid in self.clusters:
            ledger.register(cid)
        self._lock = threading.Lock()
        self._route: Dict[Tuple[str, str], int] = {}     # pod -> cluster
        self._inventory: Dict[Tuple[str, str], object] = {}  # unbound copies
        self._gang_home: Dict[str, int] = {}
        # watch fan-out: group key -> {cluster: handle}
        self._watch_groups: Dict[int, Dict[int, object]] = {}
        self._watch_seq = 0
        self.placements = 0
        self.spilled = 0
        self.fallback_placements = 0
        self.failovers = 0
        self.failover_replaced = 0

    # -- routing ----------------------------------------------------------
    def _fallback_home(self, namespace: str) -> int:
        """The namespace's home if alive, else crc32 over the live
        clusters: every client picks the same survivor."""
        live = self.ledger.live_clusters() or sorted(self.clusters)
        home = self.home_map.home_of(namespace)
        if home is not None and home in live:
            return home
        ns = namespace or "default"
        return live[zlib.crc32(b"fed:" + ns.encode()) % len(live)]

    def route_of(self, namespace: str, name: str) -> Optional[int]:
        with self._lock:
            return self._route.get((namespace or "default", name))

    # -- create -----------------------------------------------------------
    def create_pods(self, pods: Sequence) -> List:
        """Route one chunk of creates. Members of a gang whose cluster is
        recorded go there; the rest go through the federation scheduler,
        or to their home cluster when the layer is down or fails."""
        pods = list(pods)
        routed: Dict[int, List] = {}
        to_place: List = []
        live = set(self.ledger.live_clusters())
        with self._lock:
            for pod in pods:
                gang = (pod.metadata.labels or {}).get(GANG_NAME_LABEL, "")
                cid = self._gang_home.get(gang) if gang else None
                if cid is not None and cid in live:
                    routed.setdefault(cid, []).append(pod)
                else:
                    to_place.append(pod)
        # these bypass the scheduler, which reserves its own placements
        for cid, group in routed.items():
            self.ledger.note_admitted(cid, group)
        if to_place:
            for cid, placed in self._place(to_place).items():
                routed.setdefault(cid, []).extend(placed)
        created: List = []
        stranded: List = []
        for cid, group in sorted(routed.items()):
            for acid, sent in self._send(cid, group).items():
                created.extend(sent)
                with self._lock:
                    # liveness read under the registry lock: failover
                    # marks the cell dead before its sweep takes this
                    # lock, so a route recorded after the sweep sees the
                    # death here and is rescued below
                    alive = self.ledger.alive(acid)
                    for pod in sent:
                        key = (pod.metadata.namespace or "default",
                               pod.metadata.name)
                        if not alive:
                            stranded.append(pod)
                            continue
                        self._route[key] = acid
                        self._inventory[key] = _unbound_copy(pod)
                        gang = (pod.metadata.labels or {}).get(
                            GANG_NAME_LABEL, "")
                        if gang:
                            self._gang_home[gang] = acid
                    self.placements += len(sent)
        if stranded:
            self.create_pods([_unbound_copy(p) for p in stranded])
        return created

    def _send(self, cid: int, group: List) -> Dict[int, List]:
        """Deliver one routed group; if the cell fails the send, mark it
        dead and route the group to the survivors (a second failure
        propagates). Returns {cluster: pods sent there}."""
        try:
            create_chunk(self.clusters[cid], group)
            return {cid: group}
        except Exception:  # noqa: BLE001 — the cell died mid-send
            self.ledger.mark_dead(cid)
            rerouted: Dict[int, List] = {}
            for pod in group:
                alt = self._fallback_home(pod.metadata.namespace or "default")
                rerouted.setdefault(alt, []).append(pod)
            for alt, g in rerouted.items():
                create_chunk(self.clusters[alt], g)
                self.ledger.note_admitted(alt, g)
            with self._lock:
                self.fallback_placements += len(group)
            return rerouted

    def _place(self, pods: List) -> Dict[int, List]:
        """The scheduler's placement under a ``fed.route`` span, or home
        routing when it is down or fails."""
        uid = elect_trace_uid(
            p.metadata.uid or f"{p.metadata.namespace}/{p.metadata.name}"
            for p in pods)
        routed: Dict[int, List] = {}
        try:
            with get_tracer().span("fed.route", trace=uid or "",
                                   pods=len(pods)):
                placements = self.scheduler.place(pods, trace_uid=uid or "")
            for pl in placements:
                cid = pl.cluster
                if cid is None:
                    # no live cluster fits: pend at home
                    cid = pl.home if pl.home is not None \
                        else self._fallback_home(pl.unit.namespace)
                if pl.spilled:
                    self.spilled += len(pl.unit.pods)
                routed.setdefault(cid, []).extend(pl.unit.pods)
            return routed
        except Exception as e:  # noqa: BLE001 — any scheduler failure
            # routes home: the federation is never a single point of
            # failure
            if not isinstance(e, FederationUnavailable):
                _logger.warning("federation place failed (%s); home "
                                "routing", e)
            by_home: Dict[int, List] = {}
            for pod in pods:
                cid = self._fallback_home(pod.metadata.namespace or "default")
                by_home.setdefault(cid, []).append(pod)
            with self._lock:
                self.fallback_placements += len(pods)
            for cid, group in by_home.items():
                self.ledger.note_admitted(cid, group)
            return by_home

    # -- delete, read, watch ----------------------------------------------
    def delete_pod(self, namespace: str, name: str) -> None:
        key = (namespace or "default", name)
        with self._lock:
            cid = self._route.get(key)
            self._inventory.pop(key, None)
        if cid is not None:
            self.clusters[cid].delete_pod(namespace, name)

    def delete_pods(self, keys: Sequence[Tuple[str, str]]) -> None:
        by_cid: Dict[int, List[Tuple[str, str]]] = {}
        with self._lock:
            for ns, name in keys:
                key = (ns or "default", name)
                cid = self._route.get(key)
                self._inventory.pop(key, None)
                if cid is not None:
                    by_cid.setdefault(cid, []).append((ns, name))
        for cid, group in by_cid.items():
            self.clusters[cid].delete_pods(group)

    def list_pods(self) -> List:
        out: List = []
        for cid in self.ledger.live_clusters():
            out.extend(self.clusters[cid].list_pods())
        return out

    def list_nodes(self) -> List:
        out: List = []
        for cid in self.ledger.live_clusters():
            out.extend(self.clusters[cid].list_nodes())
        return out

    def watch(self, batch_fn: Callable):
        """Watch every live cluster; the handle stops them all. Each
        cluster's handle stays addressable, so ``failover_cluster`` stops
        only the dead cell's."""
        with self._lock:
            self._watch_seq += 1
            key = self._watch_seq
            group: Dict[int, object] = {}
            self._watch_groups[key] = group
        for cid in self.ledger.live_clusters():
            group[cid] = self.clusters[cid].watch(batch_fn)
        return _FederatedWatchHandle(self, key)

    def _stop_watch_group(self, key: int) -> None:
        with self._lock:
            group = self._watch_groups.pop(key, {})
        for handle in group.values():
            handle.stop()

    # -- failover -----------------------------------------------------------
    def failover_cluster(self, cid: int,
                         progress: Optional[Callable] = None) -> int:
        """Create every pod routed to the dead cluster ``cid`` again on
        the survivors (unbound copies, same names), through the
        federation scheduler with the dead column disabled, after
        stopping the dead cell's watches. Returns the pods re-created."""
        t0 = time.monotonic()
        self.ledger.mark_dead(cid)
        with self._lock:
            for group in self._watch_groups.values():
                handle = group.pop(cid, None)
                if handle is not None:
                    handle.stop()
            orphans = [self._inventory[key]
                       for key, owner in self._route.items()
                       if owner == cid and key in self._inventory]
            for key, owner in list(self._route.items()):
                if owner == cid:
                    del self._route[key]
            for gang, owner in list(self._gang_home.items()):
                if owner == cid:
                    del self._gang_home[gang]
        if progress:
            progress(f"federation: failover cluster {cid}, "
                     f"{len(orphans)} pods to re-place")
        replaced = len(self.create_pods(orphans)) if orphans else 0
        with self._lock:
            self.failovers += 1
            self.failover_replaced += replaced
        get_tracer().record("fed.failover", t0, trace=f"seam:fed-{cid}",
                            cluster=cid, replaced=replaced)
        return replaced

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {"placements": self.placements, "spilled": self.spilled,
                    "fallback_placements": self.fallback_placements,
                    "failovers": self.failovers,
                    "failover_replaced": self.failover_replaced}
