"""Node lifecycle controller: health monitoring and eviction.

The reference's ``pkg/controller/nodelifecycle/
node_lifecycle_controller.go`` (monitorNodeHealth): a node heartbeats by
renewing its ``node-<name>`` lease; a node silent past the grace period
is marked NotReady and tainted ``node.kubernetes.io/unreachable``
(NoExecute), and past the eviction grace its pods are deleted, so their
controllers replace them elsewhere. ``clock`` (default: the wall clock)
is injectable, so a test steps time by hand.
"""

from __future__ import annotations

import copy
import threading
from typing import Dict

from kubernetes_tpu_torch.api.types import (
    TAINT_NODE_UNREACHABLE,
    Node,
    PodCondition,
    Taint,
)
from kubernetes_tpu_torch.controllers.base import Controller
from kubernetes_tpu_torch.metrics.fabric_metrics import fabric_metrics
from kubernetes_tpu_torch.utils.clock import RealClock

UNREACHABLE_TAINT = TAINT_NODE_UNREACHABLE


class NodeLifecycleController(Controller):
    name = "nodelifecycle"
    monitor_interval = 1.0
    grace_period = 40.0        # the reference's nodeMonitorGracePeriod
    eviction_grace = 10.0      # the pod eviction timeout, collapsed

    def __init__(self, store, factory, clock=None):
        self._clock = clock or RealClock()
        self._not_ready_since: Dict[str, float] = {}
        self._first_seen: Dict[str, float] = {}
        super().__init__(store, factory)

    def register(self) -> None:
        self.node_lister = self.factory.lister_for("Node")
        self.pod_lister = self.factory.lister_for("Pod")
        # purge the health bookkeeping on delete, or a node registered
        # again under the same name inherits a stale not-ready time and
        # has its pods evicted at the first tick instead of after a grace
        self.factory.informer_for("Node").add_event_handler(
            on_delete=lambda n: (
                self._not_ready_since.pop(n.name, None),
                self._first_seen.pop(n.name, None),
            ),
        )
        self._monitor_stop = threading.Event()

    def run(self) -> None:
        super().run()
        t = threading.Thread(target=self._monitor_loop, daemon=True,
                             name="node-health-monitor")
        t.start()
        self._threads.append(t)

    def stop(self) -> None:
        self._monitor_stop.set()
        super().stop()

    def _monitor_loop(self) -> None:
        while not self._monitor_stop.wait(self.monitor_interval):
            self.monitor_node_health()

    # ------------------------------------------------------------------
    def heartbeat(self, node_name: str) -> None:
        """The (hollow) kubelet's heartbeat: renew the node's lease."""
        self.store.try_acquire_or_renew(
            f"node-{node_name}", node_name, self._clock.now(),
            self.grace_period,
        )

    def monitor_node_health(self) -> None:
        now = self._clock.now()
        for node in self.node_lister.list():
            # a node that never heartbeated gets the full grace from its
            # first observation (the reference grants it from the node's
            # creation). The lease outlives the node, so "never" means
            # "not since this incarnation registered": a node deleted and
            # created again under its name would otherwise inherit the
            # old incarnation's renewal time and be tainted at once
            first_seen = self._first_seen.setdefault(node.name, now)
            info = self.store.lease_info(f"node-{node.name}")
            fresh = info is not None and now - info[1] <= self.grace_period
            if not fresh and (info is None or info[1] <= first_seen):
                fresh = now - first_seen <= self.grace_period
            if fresh:
                if node.name in self._not_ready_since:
                    del self._not_ready_since[node.name]
                    self._mark_ready(node)
            else:
                since = self._not_ready_since.setdefault(node.name, now)
                self._mark_not_ready(node)
                if now - since >= self.eviction_grace:
                    self._evict_pods(node)

    def _mark_not_ready(self, node: Node) -> None:
        if any(t.key == UNREACHABLE_TAINT for t in node.spec.taints):
            return
        node = self._copy(node)
        node.spec.taints = list(node.spec.taints) + [
            Taint(key=UNREACHABLE_TAINT, effect="NoExecute")
        ]
        node.status.conditions = [
            c for c in node.status.conditions if c.type != "Ready"
        ] + [PodCondition("Ready", "False", "NodeStatusUnknown",
                          "node heartbeat lost")]
        self.store.update_node(node)

    def _mark_ready(self, node: Node) -> None:
        node = self._copy(node)
        node.spec.taints = [
            t for t in node.spec.taints if t.key != UNREACHABLE_TAINT
        ]
        node.status.conditions = [
            c for c in node.status.conditions if c.type != "Ready"
        ] + [PodCondition("Ready", "True", "KubeletReady", "")]
        self.store.update_node(node)

    @staticmethod
    def _copy(node: Node) -> Node:
        """Never mutate an informer's cached object in place."""
        new = copy.copy(node)
        new.metadata = copy.copy(node.metadata)
        new.spec = copy.copy(node.spec)
        new.status = copy.copy(node.status)
        return new

    def _evict_pods(self, node: Node) -> None:
        evicted = 0
        for pod in self.pod_lister.list():
            if pod.spec.node_name != node.name:
                continue
            if any(t.key == UNREACHABLE_TAINT
                   and t.toleration_seconds is None
                   for t in pod.spec.tolerations):
                continue  # tolerates unreachable for ever (daemons)
            self.store.delete_pod(pod.namespace, pod.name)
            evicted += 1
        if evicted:
            fabric_metrics().node_evictions_total.inc(
                "unreachable", amount=evicted)

    def sync(self, key: str) -> None:  # the monitor loop drives this one
        pass
