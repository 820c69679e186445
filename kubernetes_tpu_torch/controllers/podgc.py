"""Pod garbage collector.

The reference's ``pkg/controller/podgc`` (gc_controller.go), run on
events and on a periodic tick:

- terminated (Succeeded or Failed) pods beyond ``terminated_threshold``
  are deleted, oldest first (``gcTerminated``; the reference's default
  ``--terminated-pod-gc-threshold`` is 12,500);
- pods bound to a node that no longer exists are deleted
  (``gcOrphaned``);
- unscheduled pods that are terminating are deleted
  (``gcUnscheduledTerminating``).
"""

from __future__ import annotations

from kubernetes_tpu_torch.api.types import FAILED, SUCCEEDED
from kubernetes_tpu_torch.controllers.base import Controller
from kubernetes_tpu_torch.metrics.fabric_metrics import fabric_metrics

_SYNC_KEY = "podgc"


class PodGCController(Controller):
    name = "podgc"

    terminated_threshold = 12500
    RESYNC_SECONDS = 20.0  # the reference's gcCheckPeriod (a test lowers
    #                        it on the instance, as terminated_threshold)

    def register(self) -> None:
        # a node's delete orphans its pods at once, and a pod reaching a
        # terminal phase feeds the threshold sweep; the tick is the
        # backstop
        self.factory.informer_for("Node").add_event_handler(
            on_delete=lambda n: self.enqueue_key(_SYNC_KEY),
        )

        def pod_changed(pod) -> None:
            if pod.status.phase in (SUCCEEDED, FAILED) or \
                    pod.metadata.deletion_timestamp is not None:
                self.enqueue_key(_SYNC_KEY)

        self.factory.informer_for("Pod").add_event_handler(
            on_add=pod_changed,
            on_update=lambda old, new: pod_changed(new),
        )

    def resync(self) -> None:
        self.enqueue_key(_SYNC_KEY)

    def sync(self, key: str) -> None:
        pods = self.store.list_pods()
        nodes = {n.name for n in self.store.list_nodes()}

        # gcTerminated: the oldest terminated pods beyond the threshold
        terminated = [
            p for p in pods if p.status.phase in (SUCCEEDED, FAILED)
        ]
        excess = len(terminated) - self.terminated_threshold
        if excess > 0:
            terminated.sort(key=lambda p: p.metadata.creation_timestamp or 0)
            for p in terminated[:excess]:
                self.store.delete_pod(p.namespace, p.name)

        orphaned = 0
        for p in pods:
            # gcOrphaned: bound to a node that no longer exists
            if p.spec.node_name and p.spec.node_name not in nodes:
                self.store.delete_pod(p.namespace, p.name)
                orphaned += 1
            # gcUnscheduledTerminating
            elif not p.spec.node_name and \
                    p.metadata.deletion_timestamp is not None:
                self.store.delete_pod(p.namespace, p.name)
        if orphaned:
            fabric_metrics().node_evictions_total.inc(
                "orphaned", amount=orphaned)
