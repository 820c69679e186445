"""Per-cluster capacity and write ledgers: the facts the federation tier
decides on.

- placement: how much capacity each cluster has left (the what-if
  solve's cluster-node allocatable), and whether it is alive;
- rebalancing: which cluster and which tenant take the writes
  (``ClusterRebalancer`` differences these counters into rates).

Capacity is observed (``refresh_from`` over a cluster's node and pod
lists) plus reserved (``note_admitted`` for pods the federation routed
that the cluster's own scheduler has not bound yet). Reservations are
keyed by pod: a refresh releases exactly the reservations its observed
pod list accounts for, so a reservation noted after the list was read
survives the refresh and the same capacity is never spent twice.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.scheduler.types import (
    Resource,
    compute_pod_resource_request,
)


@dataclass
class ClusterCapacity:
    """One cluster's observed capacity and liveness."""

    cluster: int
    alive: bool = True
    nodes: int = 0
    allocatable_milli: int = 0
    allocatable_mem: int = 0
    used_milli: int = 0
    used_mem: int = 0
    bound: int = 0
    pending: int = 0
    # in-flight admissions no refresh has observed yet: sums of the
    # ledger's per-pod reservations
    admitted_milli: int = 0
    admitted_mem: int = 0
    admitted_pods: int = 0

    def remaining(self) -> Tuple[int, int]:
        """(milli-cpu, memory bytes) not yet committed: observed usage
        and in-flight reservations both count."""
        milli = self.allocatable_milli - self.used_milli \
            - self.admitted_milli
        mem = self.allocatable_mem - self.used_mem - self.admitted_mem
        return max(milli, 0), max(mem, 0)

    def utilization(self) -> float:
        """Committed share of the cpu capacity, reservations included; a
        cluster with no observed capacity reads fully used."""
        if self.allocatable_milli <= 0:
            return 1.0
        return (self.used_milli + self.admitted_milli) \
            / self.allocatable_milli


class CapacityLedger:
    """Thread-safe per-cluster ledgers: capacity for the federation
    scheduler, cumulative write counters (by cluster and by namespace)
    for the rebalancer, and liveness flags."""

    def __init__(self):
        self._lock = threading.Lock()
        self._caps: Dict[int, ClusterCapacity] = {}
        # cluster -> pod key -> (milli, mem): the reservations behind
        # the admitted_* sums
        self._admitted: Dict[int, Dict[str, Tuple[int, int]]] = {}
        self._writes: Dict[int, float] = {}
        self._ns_writes: Dict[str, float] = {}

    @staticmethod
    def _pod_key(pod) -> str:
        return pod.metadata.uid or (
            f"{pod.metadata.namespace or 'default'}/{pod.metadata.name}")

    # -- membership and liveness ----------------------------------------
    def register(self, cluster: int) -> None:
        with self._lock:
            if cluster not in self._caps:
                self._caps[cluster] = ClusterCapacity(cluster=cluster)
                self._writes[cluster] = 0.0

    def clusters(self) -> List[int]:
        with self._lock:
            return sorted(self._caps)

    def live_clusters(self) -> List[int]:
        with self._lock:
            return sorted(c for c, cap in self._caps.items() if cap.alive)

    def dead_clusters(self) -> List[int]:
        with self._lock:
            return sorted(c for c, cap in self._caps.items()
                          if not cap.alive)

    def alive(self, cluster: int) -> bool:
        with self._lock:
            cap = self._caps.get(cluster)
            return cap is not None and cap.alive

    def mark_dead(self, cluster: int) -> None:
        with self._lock:
            if cluster in self._caps:
                self._caps[cluster].alive = False

    def mark_alive(self, cluster: int) -> None:
        with self._lock:
            if cluster in self._caps:
                self._caps[cluster].alive = True

    # -- capacity --------------------------------------------------------
    def refresh_from(self, cluster: int, nodes, pods) -> ClusterCapacity:
        """Recompute a cluster's capacity from its node and pod lists. A
        pending pod counts as used (its own scheduler will bind it).
        Releases the reservations of the pods the list holds, and only
        those."""
        alloc_milli = alloc_mem = 0
        for node in nodes:
            r = Resource.from_resource_list(node.status.allocatable)
            alloc_milli += r.milli_cpu
            alloc_mem += r.memory
        used_milli = used_mem = bound = pending = 0
        observed = set()
        for pod in pods:
            req = compute_pod_resource_request(pod)
            observed.add(self._pod_key(pod))
            if pod.spec.node_name:
                bound += 1
            else:
                pending += 1
            used_milli += req.milli_cpu
            used_mem += req.memory
        with self._lock:
            cap = self._caps.setdefault(
                cluster, ClusterCapacity(cluster=cluster))
            cap.nodes = len(nodes) if hasattr(nodes, "__len__") \
                else len(list(nodes))
            cap.allocatable_milli = alloc_milli
            cap.allocatable_mem = alloc_mem
            cap.used_milli = used_milli
            cap.used_mem = used_mem
            cap.bound = bound
            cap.pending = pending
            ents = self._admitted.get(cluster) or {}
            for key in [k for k in ents if k in observed]:
                del ents[key]
            cap.admitted_milli = sum(m for m, _ in ents.values())
            cap.admitted_mem = sum(me for _, me in ents.values())
            cap.admitted_pods = len(ents)
            return ClusterCapacity(**vars(cap))

    def note_admitted(self, cluster: int, pods) -> None:
        """Reserve capacity for pods just routed to ``cluster``, and count
        their writes. Reserving a pod again replaces its entry."""
        entries: List[Tuple[str, int, int]] = []
        ns_counts: Dict[str, int] = {}
        for pod in pods:
            req = compute_pod_resource_request(pod)
            entries.append((self._pod_key(pod), req.milli_cpu, req.memory))
            ns = pod.metadata.namespace or "default"
            ns_counts[ns] = ns_counts.get(ns, 0) + 1
        with self._lock:
            cap = self._caps.setdefault(
                cluster, ClusterCapacity(cluster=cluster))
            slot = self._admitted.setdefault(cluster, {})
            for key, milli, mem in entries:
                old = slot.get(key)
                if old is not None:
                    cap.admitted_milli -= old[0]
                    cap.admitted_mem -= old[1]
                    cap.admitted_pods -= 1
                slot[key] = (milli, mem)
                cap.admitted_milli += milli
                cap.admitted_mem += mem
                cap.admitted_pods += 1
            self._writes[cluster] = \
                self._writes.get(cluster, 0.0) + len(entries)
            for ns, c in ns_counts.items():
                self._ns_writes[ns] = self._ns_writes.get(ns, 0.0) + c

    def capacity(self, cluster: int) -> Optional[ClusterCapacity]:
        with self._lock:
            cap = self._caps.get(cluster)
            return ClusterCapacity(**vars(cap)) if cap is not None else None

    def remaining(self, cluster: int) -> Tuple[int, int]:
        with self._lock:
            cap = self._caps.get(cluster)
            return cap.remaining() if cap is not None else (0, 0)

    def utilization(self, cluster: int) -> float:
        with self._lock:
            cap = self._caps.get(cluster)
            return cap.utilization() if cap is not None else 1.0

    # -- write ledgers (what the rebalancer observes) --------------------
    def write_counts(self) -> Tuple[Dict[int, float], Dict[str, float]]:
        """Cumulative (cluster -> writes, namespace -> writes); the
        rebalancer differences consecutive ticks into rates."""
        with self._lock:
            return dict(self._writes), dict(self._ns_writes)
