"""In-process cluster store for pods, nodes, PodDisruptionBudgets, the
storage objects (PersistentVolumeClaims, PersistentVolumes,
StorageClasses, CSINodes) and Events, with synchronous watch delivery,
plus the
scheduler's event handlers that turn watch events into cache and queue
updates (assigned pods feed the cache, pending pods feed the queue, node
changes feed the cache and wake parked pods, storage changes invalidate
the batch path's device state and wake parked pods).

A pod's status writes (its ``PodScheduled`` condition, its nominated
node) change the stored object in place and send no watch event, as the
JAX package's in-process store does: nothing the scheduler caches or
queues reads them.

Events (the API kind) have verbs of their own (``create_events``,
``get_event``, ``update_event``, ``list_events``,
``prune_expired_events``); their watch events reach no cache or queue, so
an Event write never moves the cache's mutation sequence."""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.types import (
    FAILED,
    SUCCEEDED,
    CSINode,
    Node,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    PodCondition,
    PodDisruptionBudget,
    StorageClass,
    shallow_copy,
)
from kubernetes_tpu_torch.api.types import Event as ApiEvent
from kubernetes_tpu_torch.scheduler import queue as q
from kubernetes_tpu_torch.scheduler.framework.plugins.coscheduling import (
    GROUP_NAME_LABEL,
)

ADDED, MODIFIED, DELETED = "ADDED", "MODIFIED", "DELETED"
# an Event object outlives its last occurrence by this long
EVENT_TTL_S = 3600.0


@dataclass
class Event:
    type: str
    kind: str
    obj: Any
    old_obj: Any = None


class WatchHandle:
    def __init__(self, store: "ClusterStore",
                 batch_fn: Callable[[List[Event]], None]):
        self._store = store
        self.batch_fn = batch_fn

    def stop(self) -> None:
        self._store._remove_watch(self)


class ClusterStore:
    def __init__(self):
        self._lock = threading.RLock()
        self._rv = 0
        self._pods: Dict[str, Pod] = {}
        self._nodes: Dict[str, Node] = {}
        self._pdbs: Dict[str, PodDisruptionBudget] = {}
        self._pvcs: Dict[str, PersistentVolumeClaim] = {}
        self._pvs: Dict[str, PersistentVolume] = {}
        self._storage_classes: Dict[str, StorageClass] = {}
        self._csi_nodes: Dict[str, CSINode] = {}
        # PV name -> claim key, assumed by VolumeBinding's Reserve
        self._assumed_pvs: Dict[str, str] = {}
        self._bound = 0   # stored pods with a node
        self._api_events: Dict[str, ApiEvent] = {}
        self.event_ttl = EVENT_TTL_S
        self._watches: List[WatchHandle] = []

    def _next_rv(self) -> str:
        self._rv += 1
        return str(self._rv)

    def _dispatch(self, events: List[Event]) -> None:
        if not events:
            return
        for w in list(self._watches):
            w.batch_fn(events)

    def _deletion_copy(self, obj):
        """The object as its deletion event carries it: a copy stamped
        with a new resource version (lock held)."""
        final = shallow_copy(obj)
        final.metadata = shallow_copy(obj.metadata)
        final.metadata.resource_version = self._next_rv()
        return final

    def watch(self, batch_fn: Callable[[List[Event]], None]) -> WatchHandle:
        """Every later mutation batch is delivered to ``batch_fn``
        synchronously, under the store lock, in commit order."""
        with self._lock:
            h = WatchHandle(self, batch_fn)
            self._watches.append(h)
            return h

    def _remove_watch(self, handle: WatchHandle) -> None:
        with self._lock:
            if handle in self._watches:
                self._watches.remove(handle)

    # ------------------------------------------------------------------
    # nodes
    def add_node(self, node: Node) -> None:
        """Create the node, or replace it (a MODIFIED event)."""
        with self._lock:
            old = self._nodes.get(node.name)
            node.metadata.resource_version = self._next_rv()
            self._nodes[node.name] = node
            self._dispatch([Event(MODIFIED if old else ADDED, "Node", node,
                                  old)])

    update_node = add_node

    def delete_node(self, name: str) -> None:
        with self._lock:
            old = self._nodes.pop(name, None)
            if old is not None:
                self._dispatch([Event(DELETED, "Node",
                                      self._deletion_copy(old))])

    def get_node(self, name: str) -> Optional[Node]:
        with self._lock:
            return self._nodes.get(name)

    def list_nodes(self) -> List[Node]:
        with self._lock:
            return list(self._nodes.values())

    # ------------------------------------------------------------------
    # pods
    def create_pods(self, pods: List[Pod]) -> List[Pod]:
        """Admit pods in bulk: one lock and one batched watch delivery, one
        resource version and one ADDED event per pod. The batch is
        validated whole first, so watchers see all of it or none."""
        with self._lock:
            seen = set()
            for pod in pods:
                key = pod.full_name()
                if key in self._pods or key in seen:
                    raise ValueError(f"pod {key} already exists")
                seen.add(key)
            events = []
            for pod in pods:
                pod.metadata.resource_version = self._next_rv()
                self._pods[pod.full_name()] = pod
                self._bound += bool(pod.spec.node_name)
                events.append(Event(ADDED, "Pod", pod))
            self._dispatch(events)
        return pods

    def update_pod(self, pod: Pod) -> Pod:
        """Replace a stored pod with ``pod`` (a MODIFIED event)."""
        with self._lock:
            key = pod.full_name()
            old = self._pods.get(key)
            if old is None:
                raise KeyError(f"pod {key} not found")
            pod.metadata.resource_version = self._next_rv()
            self._pods[key] = pod
            self._bound += bool(pod.spec.node_name) - bool(old.spec.node_name)
            self._dispatch([Event(MODIFIED, "Pod", pod, old)])
            return pod

    def delete_pod(self, namespace: str, name: str) -> None:
        self.delete_pods([(namespace, name)])

    def delete_pods(self, keys: List[Tuple[str, str]]) -> None:
        """Delete (namespace, name) pods in bulk: one lock and one batched
        watch delivery; names not stored are skipped."""
        events: List[Event] = []
        with self._lock:
            for namespace, name in keys:
                old = self._pods.pop(f"{namespace}/{name}", None)
                if old is not None:
                    self._bound -= bool(old.spec.node_name)
                    events.append(Event(DELETED, "Pod",
                                        self._deletion_copy(old)))
            self._dispatch(events)

    def get_pod(self, namespace: str, name: str) -> Optional[Pod]:
        with self._lock:
            return self._pods.get(f"{namespace}/{name}")

    def list_pods(self) -> List[Pod]:
        with self._lock:
            return list(self._pods.values())

    def count_bound(self) -> int:
        """Stored pods with a node, without scanning them."""
        with self._lock:
            return self._bound

    def patch_pod_condition(self, namespace: str, name: str,
                            condition: PodCondition) -> None:
        """Set the pod's condition of ``condition.type``."""
        with self._lock:
            pod = self._pods.get(f"{namespace}/{name}")
            if pod is None:
                return
            pod.status.conditions = [
                c for c in pod.status.conditions if c.type != condition.type
            ] + [condition]

    def set_nominated_node_name(self, namespace: str, name: str,
                                node: str) -> None:
        with self._lock:
            pod = self._pods.get(f"{namespace}/{name}")
            if pod is not None:
                pod.status.nominated_node_name = node

    def clear_nominated_node_name(self, namespace: str, name: str) -> None:
        self.set_nominated_node_name(namespace, name, "")

    def batched_status_writes(self):
        """A scope for many status writes; each store call is already one
        lock acquisition, so there is nothing to collapse."""
        return contextlib.nullcontext()

    def bind(self, namespace: str, name: str, uid: str, node_name: str
             ) -> None:
        err = self.bind_many([(namespace, name, uid, node_name)])[0]
        if err is not None:
            raise err

    def bind_many(self, bindings: List[Tuple[str, str, str, str]]
                  ) -> List[Optional[Exception]]:
        """The Binding subresource in bulk: (namespace, name, uid, node)
        each set spec.nodeName on a fresh copy of the live pod, failing on
        a missing pod, a uid mismatch or a pod bound elsewhere. Failures
        come back positionally; one batched watch delivery."""
        errors: List[Optional[Exception]] = [None] * len(bindings)
        events: List[Event] = []
        with self._lock:
            for i, (namespace, name, uid, node_name) in enumerate(bindings):
                key = f"{namespace}/{name}"
                pod = self._pods.get(key)
                if pod is None:
                    errors[i] = KeyError(f"pod {key} not found")
                    continue
                if uid and pod.uid != uid:
                    errors[i] = ValueError(f"pod {key} uid mismatch")
                    continue
                if pod.spec.node_name and pod.spec.node_name != node_name:
                    errors[i] = ValueError(
                        f"pod {key} is already assigned to node "
                        f"{pod.spec.node_name!r}")
                    continue
                new_pod = shallow_copy(pod)
                new_pod.spec = shallow_copy(pod.spec)
                new_pod.spec.node_name = node_name
                new_pod.metadata = shallow_copy(pod.metadata)
                new_pod.metadata.resource_version = self._next_rv()
                self._pods[key] = new_pod
                self._bound += not pod.spec.node_name
                events.append(Event(MODIFIED, "Pod", new_pod, pod))
            self._dispatch(events)
        return errors

    # ------------------------------------------------------------------
    # Events
    def create_events(self, events: List[ApiEvent]) -> int:
        """Create ``events`` under one lock and one watch delivery; a name
        already taken is skipped. Returns how many were created."""
        delivered: List[Event] = []
        with self._lock:
            for ev in events:
                key = f"{ev.metadata.namespace}/{ev.metadata.name}"
                if key in self._api_events:
                    continue
                ev.metadata.resource_version = self._next_rv()
                self._api_events[key] = ev
                delivered.append(Event(ADDED, "Event", ev))
            self._dispatch(delivered)
        return len(delivered)

    def get_event(self, namespace: str, name: str) -> Optional[ApiEvent]:
        with self._lock:
            return self._api_events.get(f"{namespace}/{name}")

    def update_event(self, ev: ApiEvent) -> ApiEvent:
        """Replace a stored Event; a missing one raises KeyError."""
        with self._lock:
            key = f"{ev.metadata.namespace}/{ev.metadata.name}"
            old = self._api_events.get(key)
            if old is None:
                raise KeyError(f"Event {key!r} not found")
            ev.metadata.resource_version = self._next_rv()
            self._api_events[key] = ev
            self._dispatch([Event(MODIFIED, "Event", ev, old)])
            return ev

    def list_events(self, namespace: Optional[str] = None,
                    involved_name: Optional[str] = None) -> List[ApiEvent]:
        with self._lock:
            return [ev for ev in self._api_events.values()
                    if (namespace is None
                        or ev.metadata.namespace == namespace)
                    and (involved_name is None
                         or ev.involved_object.name == involved_name)]

    def prune_expired_events(self, now: Optional[float] = None) -> int:
        """Delete the Events whose last occurrence is older than
        ``event_ttl``. Returns how many."""
        now = time.time() if now is None else now
        with self._lock:
            stale = [key for key, ev in self._api_events.items()
                     if now - ev.last_timestamp > self.event_ttl]
            events = [Event(DELETED, "Event",
                            self._deletion_copy(self._api_events.pop(key)))
                      for key in stale]
            self._dispatch(events)
        return len(stale)

    # ------------------------------------------------------------------
    # PodDisruptionBudgets; the controller objects SelectorSpread reads
    # (Services, ReplicationControllers, ReplicaSets, StatefulSets) are
    # not stored yet, so their listers return nothing
    def add_pdb(self, pdb: PodDisruptionBudget) -> None:
        with self._lock:
            pdb.metadata.resource_version = self._next_rv()
            self._pdbs[f"{pdb.namespace}/{pdb.name}"] = pdb

    def list_pdbs(self) -> List[PodDisruptionBudget]:
        with self._lock:
            return list(self._pdbs.values())

    def list_services(self, namespace: str) -> List:
        return []

    def list_replication_controllers(self, namespace: str) -> List:
        return []

    def list_replica_sets(self, namespace: str) -> List:
        return []

    def list_stateful_sets(self, namespace: str) -> List:
        return []

    # ------------------------------------------------------------------
    # storage objects: each create or replace is one ADDED or MODIFIED
    # event
    def _upsert(self, table: Dict, kind: str, key: str, obj) -> None:
        with self._lock:
            old = table.get(key)
            obj.metadata.resource_version = self._next_rv()
            table[key] = obj
            self._dispatch([Event(MODIFIED if old is not None else ADDED,
                                  kind, obj, old)])

    def add_pvc(self, pvc: PersistentVolumeClaim) -> None:
        self._upsert(self._pvcs, "PersistentVolumeClaim",
                     f"{pvc.namespace}/{pvc.name}", pvc)

    def get_pvc(self, namespace: str, name: str
                ) -> Optional[PersistentVolumeClaim]:
        with self._lock:
            return self._pvcs.get(f"{namespace}/{name}")

    def list_all_pvcs(self) -> List[PersistentVolumeClaim]:
        with self._lock:
            return list(self._pvcs.values())

    def add_pv(self, pv: PersistentVolume) -> None:
        self._upsert(self._pvs, "PersistentVolume", pv.name, pv)

    def get_pv(self, name: str) -> Optional[PersistentVolume]:
        with self._lock:
            return self._pvs.get(name)

    def list_pvs(self) -> List[PersistentVolume]:
        with self._lock:
            return list(self._pvs.values())

    def add_storage_class(self, sc: StorageClass) -> None:
        self._upsert(self._storage_classes, "StorageClass", sc.name, sc)

    def get_storage_class(self, name: str) -> Optional[StorageClass]:
        with self._lock:
            return self._storage_classes.get(name)

    def list_storage_classes(self) -> List[StorageClass]:
        with self._lock:
            return list(self._storage_classes.values())

    def add_csi_node(self, cn: CSINode) -> None:
        self._upsert(self._csi_nodes, "CSINode", cn.metadata.name, cn)

    def get_csi_node(self, name: str) -> Optional[CSINode]:
        with self._lock:
            return self._csi_nodes.get(name)

    def list_csi_nodes(self) -> List[CSINode]:
        with self._lock:
            return list(self._csi_nodes.values())

    # the volume binder's assume and commit
    def assume_pv_bound(self, pv_name: str, pvc_key: str) -> None:
        with self._lock:
            self._assumed_pvs[pv_name] = pvc_key

    def revert_assumed_pv(self, pv_name: str) -> None:
        with self._lock:
            self._assumed_pvs.pop(pv_name, None)

    def bind_pv(self, pv_name: str, pvc_namespace: str, pvc_name: str
                ) -> bool:
        """Bind the PV and the claim to each other, in place (a MODIFIED
        event each). False when either is missing."""
        with self._lock:
            pv = self._pvs.get(pv_name)
            pvc = self._pvcs.get(f"{pvc_namespace}/{pvc_name}")
            if pv is None or pvc is None:
                return False
            pv.claim_ref = f"{pvc_namespace}/{pvc_name}"
            pv.phase = "Bound"
            pvc.volume_name = pv_name
            pvc.phase = "Bound"
            self._assumed_pvs.pop(pv_name, None)
            self._dispatch([Event(MODIFIED, "PersistentVolume", pv),
                            Event(MODIFIED, "PersistentVolumeClaim", pvc)])
            return True

    def unbind_pv(self, pv_name: str, pvc_namespace: str, pvc_name: str
                  ) -> bool:
        """Undo ``bind_pv`` of a pair bound to each other; False (and
        nothing changed) for any other pair."""
        with self._lock:
            pv = self._pvs.get(pv_name)
            pvc = self._pvcs.get(f"{pvc_namespace}/{pvc_name}")
            if pv is None or pvc is None:
                return False
            if pv.claim_ref != f"{pvc_namespace}/{pvc_name}" or \
                    pvc.volume_name != pv_name:
                return False
            pv.claim_ref = None
            pv.phase = "Available"
            pvc.volume_name = ""
            pvc.phase = "Pending"
            self._dispatch([Event(MODIFIED, "PersistentVolume", pv),
                            Event(MODIFIED, "PersistentVolumeClaim", pvc)])
            return True


# ----------------------------------------------------------------------
def assigned(pod: Pod) -> bool:
    return bool(pod.spec.node_name)


def schedulable(pod: Pod) -> bool:
    """Terminal-phase pods are invisible to the scheduler."""
    return pod.status.phase not in (SUCCEEDED, FAILED)


# storage kind -> the queue events its ADDED and MODIFIED events are
STORAGE_EVENTS = {
    "PersistentVolume": {ADDED: q.PV_ADD, MODIFIED: q.PV_UPDATE},
    "PersistentVolumeClaim": {ADDED: q.PVC_ADD, MODIFIED: q.PVC_UPDATE},
    "StorageClass": {ADDED: q.STORAGE_CLASS_ADD},
    "CSINode": {ADDED: q.CSI_NODE_ADD, MODIFIED: q.CSI_NODE_UPDATE},
}


class EventHandlers:
    """Watch batches -> cache and queue. Runs of pod events of one kind
    (bind transitions, pending adds, deletions of assigned pods) collapse
    into one cache or queue call; their order relative to other events is
    kept by flushing the run before any other event.

    Storage: every PV, PVC, StorageClass or CSINode event bumps the
    cache's mutation sequence (the encoder reads volume masks and attach
    budgets from those objects, so the batch path's device state is then
    rebuilt), and an add or update wakes parked pods.

    Gangs: a pending member added wakes its gang's parked siblings; a
    bound member deleted releases its arrival slot at Coscheduling's
    Permit; a pending pod deleted while it waits at Permit is rejected
    there."""

    def __init__(self, scheduler):
        self.sched = scheduler

    def responsible_for(self, pod: Pod) -> bool:
        return pod.spec.scheduler_name == self.sched.scheduler_name

    def handle_many(self, events: List[Event]) -> None:
        sched = self.sched
        if any(e.kind != "Event" for e in events):
            # delivery is synchronous: the batch commits now
            sched.cache.note_event_ts(time.time())
        bind_run: List[Pod] = []    # pods newly assigned
        add_run: List[Pod] = []     # pending pods added
        delete_run: List[Pod] = []  # assigned pods deleted
        runs = (bind_run, add_run, delete_run)

        def flush():
            if bind_run:
                sched.cache.add_pods(bind_run)
                sched.queue.delete_many(bind_run)
                sched.queue.assigned_pods_updated(bind_run)
                bind_run.clear()
            if add_run:
                sched.queue.add_many(add_run)
                sched.queue.gang_members_added({
                    g for p in add_run
                    if (g := p.metadata.labels.get(GROUP_NAME_LABEL))})
                add_run.clear()
            if delete_run:
                for pod in delete_run:
                    sched.cache.remove_pod(pod)
                    self._gang_member_deleted(pod)
                # one wakeup for the whole run
                sched.queue.move_all_to_active_or_backoff_queue(
                    q.ASSIGNED_POD_DELETE)
                delete_run.clear()

        def run_for(target):
            if any(r for r in runs if r is not target):
                flush()
            return target

        for event in events:
            pod = event.obj
            if event.kind == "Pod":
                if (event.type == MODIFIED and assigned(pod)
                        and event.old_obj is not None
                        and not assigned(event.old_obj)):
                    run_for(bind_run).append(pod)
                    continue
                if (event.type == ADDED and not assigned(pod)
                        and schedulable(pod) and self.responsible_for(pod)):
                    run_for(add_run).append(pod)
                    continue
                if event.type == DELETED and assigned(pod):
                    run_for(delete_run).append(pod)
                    continue
            flush()
            self._handle_one(event)
        flush()

    def _handle_one(self, event: Event) -> None:
        if event.kind == "Pod":
            self._handle_pod(event)
        elif event.kind == "Node":
            self._handle_node(event)
        elif event.kind in STORAGE_EVENTS:
            self.sched.cache.note_external_mutation()
            name = STORAGE_EVENTS[event.kind].get(event.type)
            if name:
                self.sched.queue.move_all_to_active_or_backoff_queue(name)

    def _handle_pod(self, event: Event) -> None:
        sched = self.sched
        pod, old = event.obj, event.old_obj
        if event.type == ADDED:
            if assigned(pod):
                sched.cache.add_pods([pod])
                sched.queue.assigned_pods_updated([pod])
        elif event.type == MODIFIED:
            if assigned(pod):
                if old is not None and not assigned(old):
                    sched.cache.add_pods([pod])
                    sched.queue.delete(pod)
                else:
                    sched.cache.update_pod(old or pod, pod)
                sched.queue.assigned_pods_updated([pod])
            elif schedulable(pod) and self.responsible_for(pod):
                if not self._skip_pod_update(old, pod):
                    sched.queue.update(old, pod)
        elif event.type == DELETED:
            if assigned(pod):
                sched.cache.remove_pod(pod)
                sched.queue.move_all_to_active_or_backoff_queue(
                    q.ASSIGNED_POD_DELETE)
                self._gang_member_deleted(pod)
            else:
                sched.queue.delete(pod)
                # a pod parked at Permit gives back its assume and its
                # gang slot
                sched.framework.reject_waiting_pod(pod.uid)

    def _gang_member_deleted(self, pod: Pod) -> None:
        if pod.metadata.labels.get(GROUP_NAME_LABEL):
            gang = self.sched.framework.get_plugin("Coscheduling")
            if gang is not None:
                gang.note_member_deleted(pod)

    def _skip_pod_update(self, old: Optional[Pod], new: Pod) -> bool:
        """An update of an assumed pod that leaves its spec and labels
        alone does not touch the queue."""
        if old is None or not self.sched.cache.is_assumed_pod(new):
            return False
        return (old.spec == new.spec
                and old.metadata.labels == new.metadata.labels)

    def _handle_node(self, event: Event) -> None:
        sched = self.sched
        node, old = event.obj, event.old_obj
        if event.type == ADDED:
            sched.cache.add_node(node)
            sched.queue.move_all_to_active_or_backoff_queue(q.NODE_ADD)
        elif event.type == MODIFIED:
            sched.cache.update_node(old or node, node)
            change = self._node_scheduling_properties_change(old, node)
            if change:
                sched.queue.move_all_to_active_or_backoff_queue(change)
        elif event.type == DELETED:
            sched.cache.remove_node(node)

    @staticmethod
    def _node_scheduling_properties_change(old: Optional[Node], new: Node
                                           ) -> Optional[str]:
        """The event a node update is, if it could make a parked pod
        schedulable; None otherwise."""
        if old is None:
            return q.NODE_ADD
        if old.spec.unschedulable != new.spec.unschedulable:
            return q.NODE_SPEC_UNSCHEDULABLE_CHANGE
        if old.status.allocatable != new.status.allocatable:
            return q.NODE_ALLOCATABLE_CHANGE
        if old.metadata.labels != new.metadata.labels:
            return q.NODE_LABEL_CHANGE
        if old.spec.taints != new.spec.taints:
            return q.NODE_TAINT_CHANGE
        return None
