"""Node-pressure eviction manager.

Behavioral equivalent of the reference's ``pkg/kubelet/eviction``
(eviction_manager.go synchronize): observe node-local resource signals
through a stats provider, compare against configured thresholds, and
under pressure (a) publish the pressure node condition + its NoSchedule
taint so the scheduler steers away, (b) rank the node's pods by the
reference's eviction order — pods exceeding their requests first, then
by priority, then by usage — and evict one pod per pass until the
signal clears (evictPod + annotations, one victim per synchronize).

The stats provider is pluggable; the default ``CgroupStatsStub`` sums
the node's pod REQUESTS as "usage" so the harness (no real kernel)
exercises the full pipeline deterministically.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from kubernetes_tpu_torch.api.resource import parse_quantity
from kubernetes_tpu_torch.api.types import PodCondition, Taint, shallow_copy
from kubernetes_tpu_torch.scheduler.types import compute_pod_resource_request

MEMORY_PRESSURE = "MemoryPressure"
DISK_PRESSURE = "DiskPressure"
MEMORY_PRESSURE_TAINT = "node.kubernetes.io/memory-pressure"

# signal name -> node condition (eviction/api/types.go signals)
SIGNAL_MEMORY_AVAILABLE = "memory.available"


class CgroupStatsStub:
    """Deterministic stats provider: usage = sum of pod memory requests
    (a real node would read cgroup/cadvisor summaries)."""

    def __init__(self, store, node_name: str, capacity_bytes: int):
        self.store = store
        self.node_name = node_name
        self.capacity = capacity_bytes

    def memory_available(self) -> int:
        used = 0
        for p in self.store.list_pods():
            if p.spec.node_name != self.node_name:
                continue
            if p.status.phase in ("Succeeded", "Failed"):
                continue
            used += compute_pod_resource_request(p).memory
        return max(0, self.capacity - used)


class EvictionManager:
    def __init__(
        self,
        store,
        node_name: str,
        thresholds: Optional[Dict[str, str]] = None,
        stats: Optional[object] = None,
        recorder=None,
    ):
        self.store = store
        self.node_name = node_name
        raw = dict(thresholds or {SIGNAL_MEMORY_AVAILABLE: "100Mi"})
        self.thresholds = {
            k: int(parse_quantity(v).value()) for k, v in raw.items()
        }
        self.stats = stats
        self.recorder = recorder
        self._lock = threading.Lock()
        self.evicted: List[str] = []  # pod keys, observability

    # ------------------------------------------------------------------
    def synchronize(self) -> Optional[str]:
        """One pass (eviction_manager.go:231 synchronize): returns the
        evicted pod's key, or None when no eviction was needed."""
        threshold = self.thresholds.get(SIGNAL_MEMORY_AVAILABLE)
        if threshold is None or self.stats is None:
            return None
        available = self.stats.memory_available()
        under_pressure = available < threshold
        self._set_pressure(under_pressure)
        if not under_pressure:
            return None
        victims = self._rank_pods()
        for pod in victims:
            key = f"{pod.namespace}/{pod.name}"
            message = (
                "The node was low on resource: memory. "
                f"Threshold quantity: {threshold}, available: {available}"
            )
            if self.recorder is not None:
                self.recorder.eventf(pod, "Warning", "Evicted", "%s",
                                     message)

            # the reference's evictPod marks the pod Failed with
            # reason=Evicted rather than deleting it — the object stays
            # observable for workload controllers/operators; podgc or
            # the owner cleans it up later (eviction_manager.go
            # evictPod -> killPod, status_manager terminal phase)
            def mark(p):
                p.status.phase = "Failed"
                p.status.reason = "Evicted"
                p.status.message = message

            self.store.mutate_object("Pod", pod.namespace, pod.name, mark)
            with self._lock:
                self.evicted.append(key)
            return key  # one victim per pass, then re-observe
        return None

    def _rank_pods(self) -> List:
        """Eviction order (eviction/helpers.go rankMemoryPressure):
        usage-over-request first, then ascending priority, then largest
        usage. Per-pod usage comes from the stats provider's optional
        ``pod_memory_usage(pod)``; providers without it (the cgroup
        stub) fall back to usage = request, collapsing the order to
        priority-then-largest-request."""
        pods = [
            p for p in self.store.list_pods()
            if p.spec.node_name == self.node_name
            and p.status.phase not in ("Succeeded", "Failed")
            # already deletion-marked (e.g. waiting on a finalizer):
            # re-"evicting" it every pass would livelock while the
            # second-ranked pod never gets evicted
            and p.metadata.deletion_timestamp is None
        ]
        usage_fn = getattr(self.stats, "pod_memory_usage", None)

        def key(p):
            req = compute_pod_resource_request(p).memory
            usage = usage_fn(p) if usage_fn is not None else req
            over = usage > req
            return (not over, p.priority(), -usage)

        pods.sort(key=key)
        return pods

    # ------------------------------------------------------------------
    def _set_pressure(self, under: bool) -> None:
        def mutate(n) -> bool:
            have = any(
                c.type == MEMORY_PRESSURE and c.status == "True"
                for c in n.status.conditions
            )
            if have == under:
                return False
            n.status.conditions = [
                c for c in n.status.conditions
                if c.type != MEMORY_PRESSURE
            ] + [PodCondition(
                MEMORY_PRESSURE,
                "True" if under else "False",
                "KubeletHasInsufficientMemory" if under
                else "KubeletHasSufficientMemory",
            )]
            n.spec = shallow_copy(n.spec)
            taints = [t for t in n.spec.taints
                      if t.key != MEMORY_PRESSURE_TAINT]
            if under:
                taints.append(Taint(key=MEMORY_PRESSURE_TAINT,
                                    effect="NoSchedule"))
            n.spec.taints = taints
            return True

        # CAS mutate: other node-status writers (attachdetach, image
        # GC) must not be clobbered by a stale read
        self.store.mutate_object("Node", "", self.node_name, mutate)
