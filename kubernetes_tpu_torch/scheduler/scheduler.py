"""The scheduler shell the batch path runs in: it owns the cache, the
queue and the snapshot, wires the store's watch into them, and commits a
solved batch (assume in the cache, bind in the store) or requeues the
pods the solve could not place. The per-pod filter/score framework and
preemption are not part of this package."""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

from kubernetes_tpu_torch.apiserver.store import (
    ClusterStore,
    EventHandlers,
    assigned,
)
from kubernetes_tpu_torch.api.types import (
    NO_SCHEDULE,
    TAINT_NODE_UNREACHABLE,
    TAINT_NODE_UNSCHEDULABLE,
    Node,
    Pod,
    Taint,
    shallow_copy,
)
from kubernetes_tpu_torch.scheduler.cache import SchedulerCache
from kubernetes_tpu_torch.scheduler.queue import SchedulingQueue
from kubernetes_tpu_torch.scheduler.snapshot import Snapshot
from kubernetes_tpu_torch.scheduler.types import PodInfo, QueuedPodInfo


def commit_target_stale(pod: Pod, node: Optional[Node]) -> Optional[str]:
    """Why binding ``pod`` to a node ``SchedulerCache.commit_target_flags``
    flagged would bind into the void ("deleted", "cordoned",
    "unreachable"), or None when the pod may still go there (it tolerates
    the taint)."""
    if node is None:
        return "deleted"
    tolerations = pod.spec.tolerations
    if node.spec.unschedulable:
        cordon = Taint(TAINT_NODE_UNSCHEDULABLE, "", NO_SCHEDULE)
        if not any(t.tolerates(cordon) for t in tolerations):
            return "cordoned"
    for taint in node.spec.taints:
        if taint.key == TAINT_NODE_UNREACHABLE and not any(
                t.tolerates(taint) for t in tolerations):
            return "unreachable"
    return None


class Scheduler:
    scheduler_name = "default-scheduler"

    def __init__(self, store: ClusterStore):
        self.client = store
        self.cache = SchedulerCache()
        self.queue = SchedulingQueue()
        self.snapshot = Snapshot()
        self.event_handlers = EventHandlers(self)
        self._watch_handle = None
        # per bound pod: seconds from its batch's solve start to the bind,
        # and from its first enqueue to the bind
        self.cycle_latencies: List[float] = []
        self.pending_latencies: List[float] = []

    def start(self) -> None:
        """Watch the store, then replay what it already holds."""
        if self._watch_handle is None:
            self._watch_handle = self.client.watch(
                self.event_handlers.handle_many)
        for node in self.client.list_nodes():
            self.cache.add_node(node)
        pending = []
        for pod in self.client.list_pods():
            if assigned(pod):
                self.cache.add_pod(pod)
            elif self.event_handlers.responsible_for(pod):
                pending.append(pod)
        self.queue.add_many(pending)

    def stop(self) -> None:
        if self._watch_handle is not None:
            self._watch_handle.stop()
            self._watch_handle = None

    def update_snapshot(self) -> Snapshot:
        self.cache.update_snapshot(self.snapshot)
        return self.snapshot

    def skip_pod_schedule(self, pod: Pod) -> bool:
        """Deleting, already-assumed and already-bound pods skip."""
        return (pod.metadata.deletion_timestamp is not None
                or self.cache.is_assumed_pod(pod) or assigned(pod))

    def fail_unschedulable(self, qpi: QueuedPodInfo, cycle: int) -> None:
        self.queue.add_unschedulable_if_not_present(qpi, cycle)

    def commit_assignments_bulk(
            self, commits: List[Tuple[QueuedPodInfo, str, int, float]]
    ) -> Tuple[int, int]:
        """Commit (qpi, node name, cycle, solve start) placements: assume
        them in the cache under one lock, bind them in the store in one
        call, start their assume expiry. A pod the cache or the store
        refuses is requeued. Returns (committed, cache mutations made)."""
        assumed_pods: List[Pod] = []
        for qpi, node_name, _, _ in commits:
            assumed = shallow_copy(qpi.pod)
            assumed.spec = shallow_copy(qpi.pod.spec)
            assumed.spec.node_name = node_name
            PodInfo.derived(assumed, qpi.pod_info)
            assumed_pods.append(assumed)
        errors = self.cache.assume_pods(assumed_pods)
        live = [(item, pod) for item, pod, err
                in zip(commits, assumed_pods, errors) if err is None]
        mutations = len(live)
        for item, err in zip(commits, errors):
            if err is not None:
                self.queue.add_unschedulable_if_not_present(item[0], item[2])
        bind_errors = self.client.bind_many([
            (pod.namespace, pod.name, pod.uid, pod.spec.node_name)
            for _, pod in live])
        now = time.monotonic()
        committed = 0
        for ((qpi, _, cycle, start), pod), err in zip(live, bind_errors):
            if err is not None:
                self.cache.forget_pod(pod)
                mutations += 1
                self.queue.add_unschedulable_if_not_present(qpi, cycle)
                continue
            self.cache.finish_binding(pod, now)
            self.cycle_latencies.append(now - start)
            self.pending_latencies.append(now - qpi.initial_attempt_timestamp)
            committed += 1
        return committed, mutations
