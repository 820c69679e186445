"""In-process cluster store for pods, nodes, PodDisruptionBudgets, the
controller objects SelectorSpread reads (Services, Endpoints,
ReplicationControllers, ReplicaSets, StatefulSets), the storage objects
(PersistentVolumeClaims, PersistentVolumes, StorageClasses, CSINodes)
and Events, with synchronous watch delivery, plus the scheduler's event
handlers that turn watch events into cache and queue
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
an Event write never moves the cache's mutation sequence.

The REST fabric (``apiserver/rest.py``) serves the store through the
generic verbs (``create_object``, ``get_object``, ``list_objects_with_rv``,
``update_object`` with a resourceVersion precondition, ``delete_object``)
over every kind of ``api.serialization.SCHEME``, plus the tables RBAC
and admission read (roles and bindings, namespaces, service accounts,
priority classes, resource quotas). Every dispatched event carries its
commit time (``ts``, the watch-delivery SLI's anchor) and the sampled
trace context of the request that committed it (``origin``);
``kind_seq`` counts each kind's mutations, status writes included, for
the server's pre-encoded list cache. ``mutate_object`` is a read, modify,
write with a resourceVersion precondition (the kubelet's node status
writes).

As one partition of a ``PartitionedStore`` (``apiserver/partition.py``) a
store takes its versions from a shared counter (``rv_source``), and a
slice of the keyspace moves between partitions over the silent
placement channel (``adopt_objects``, ``evict_objects``): no watcher
hears the move, the WAL (``watch_silent``) does. A read replica's mirror
store applies its owner's events with their versions kept and dispatches
them (``apply_replicated``)."""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.types import (
    FAILED,
    SUCCEEDED,
    ClusterRole,
    ClusterRoleBinding,
    CSINode,
    Endpoints,
    Lease,
    Namespace,
    ObjectMeta,
    ResourceQuota,
    Role,
    RoleBinding,
    ServiceAccount,
    Node,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    PodCondition,
    PodDisruptionBudget,
    ReplicaSet,
    ReplicationController,
    Service,
    StatefulSet,
    StorageClass,
    shallow_copy,
)
from kubernetes_tpu_torch.api.types import Event as ApiEvent
from kubernetes_tpu_torch.metrics.freshness_metrics import freshness_metrics
from kubernetes_tpu_torch.observability.tracer import current_request_context
from kubernetes_tpu_torch.scheduler import queue as q
from kubernetes_tpu_torch.scheduler.framework.plugins.coscheduling import (
    GROUP_NAME_LABEL,
)

ADDED, MODIFIED, DELETED = "ADDED", "MODIFIED", "DELETED"
# an Event object outlives its last occurrence by this long
EVENT_TTL_S = 3600.0


class ConflictError(Exception):
    """A resourceVersion precondition failed (HTTP 409)."""


@dataclass
class Event:
    type: str
    kind: str
    obj: Any
    old_obj: Any = None
    # wall-clock commit time, stamped once at dispatch (0.0: not
    # stamped, as with ``KTPU_FRESHNESS=off``)
    ts: float = 0.0
    # the X-Ktpu-Trace value of the sampled request whose commit
    # produced the event; None when untraced
    origin: Any = None


def _commit_origin():
    """The sampled inbound trace context of the request committing on
    this thread (the REST handler sets it), in its wire form, or None."""
    ctx = current_request_context()
    if ctx is not None and ctx.sampled:
        return ctx.header_value()
    return None


class WatchHandle:
    def __init__(self, store: "ClusterStore",
                 batch_fn: Callable[[List[Event]], None]):
        self._store = store
        self.batch_fn = batch_fn

    def stop(self) -> None:
        self._store._remove_watch(self)


class ClusterStore:
    def __init__(self, rv_source: Optional[Callable[[], int]] = None):
        self._lock = threading.RLock()
        self._rv = 0
        # a shared resourceVersion allocator (the partitioned store hands
        # each partition the same counter, so versions stay unique and
        # comparable across partitions); None: this store counts alone
        self._rv_source = rv_source
        self._pods: Dict[str, Pod] = {}
        self._nodes: Dict[str, Node] = {}
        self._pdbs: Dict[str, PodDisruptionBudget] = {}
        self._pvcs: Dict[str, PersistentVolumeClaim] = {}
        self._pvs: Dict[str, PersistentVolume] = {}
        self._storage_classes: Dict[str, StorageClass] = {}
        self._csi_nodes: Dict[str, CSINode] = {}
        self._services: Dict[str, Service] = {}
        self._endpoints: Dict[str, Endpoints] = {}
        self._rcs: Dict[str, ReplicationController] = {}
        self._rss: Dict[str, ReplicaSet] = {}
        self._sss: Dict[str, StatefulSet] = {}
        # PV name -> claim key, assumed by VolumeBinding's Reserve
        self._assumed_pvs: Dict[str, str] = {}
        self._bound = 0   # stored pods with a node
        self._api_events: Dict[str, ApiEvent] = {}
        self.event_ttl = EVENT_TTL_S
        self._watches: List[WatchHandle] = []
        self._leases: Dict[str, "_Lease"] = {}
        # the tables RBAC and admission read
        self._roles: Dict[str, Role] = {}
        self._cluster_roles: Dict[str, ClusterRole] = {}
        self._role_bindings: Dict[str, RoleBinding] = {}
        self._cluster_role_bindings: Dict[str, ClusterRoleBinding] = {}
        self._namespaces: Dict[str, Namespace] = {}
        self._quotas: Dict[str, ResourceQuota] = {}
        self._service_accounts: Dict[str, ServiceAccount] = {}
        self._priority_classes: Dict[str, Any] = {}
        self._secrets: Dict[str, Any] = {}
        self._config_maps: Dict[str, Any] = {}
        # per-kind mutation counters, status writes included
        self._kind_seq: Dict[str, int] = {}
        self._freshness = freshness_metrics()
        # observers of the silent placement channel (``adopt_objects``,
        # ``evict_objects``): the WAL hears a slice move, watchers do not
        self._silent_sinks: List[Callable[[List[Event]], None]] = []

    def _next_rv(self) -> str:
        if self._rv_source is not None:
            # from the shared counter, remembered here: ``current_rv``
            # stays the newest version this store committed
            self._rv = self._rv_source()
        else:
            self._rv += 1
        return str(self._rv)

    def kind_seq(self, kind: str) -> int:
        """Mutations of one kind so far (the REST list cache's key). Read
        without the lock: one dict read is atomic, and a writer bumps the
        count after its table change, inside the lock, so a reader that
        then lists sees that change. Under a list storm, the lock's
        queue would otherwise hold every list behind every writer."""
        return self._kind_seq.get(kind, 0)

    def _bump_kind(self, kind: str) -> None:
        self._kind_seq[kind] = self._kind_seq.get(kind, 0) + 1

    def _dispatch(self, events: List[Event]) -> None:
        if not events:
            return
        origin = _commit_origin()
        now = time.time() if self._freshness.enabled else 0.0
        for e in events:
            self._bump_kind(e.kind)
            if not e.ts:
                e.ts = now
            if e.origin is None:
                e.origin = origin
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
    # the silent placement channel (a partition's slice moving between
    # stores): the objects did not change, only where they live, so
    # watchers hear nothing, and the WAL hears every move
    def watch_silent(self, batch_fn: Callable[[List[Event]], None]
                     ) -> "_SilentHandle":
        """``batch_fn`` hears each ``adopt_objects`` (MODIFIED events) and
        ``evict_objects`` (DELETED events) batch; returns a stop handle."""
        with self._lock:
            self._silent_sinks.append(batch_fn)
        return _SilentHandle(self, batch_fn)

    def _dispatch_silent(self, events: List[Event]) -> None:
        for e in events:
            # the REST list cache keys on the kind's mutation count
            self._bump_kind(e.kind)
        for fn in list(self._silent_sinks):
            fn(events)

    def adopt_objects(self, kind: str, objs: List[Any]) -> int:
        """Insert objects with their resourceVersions kept and no watch
        event: the receiving half of a slice move. A stored entry is
        replaced only by an equal or newer version, and this store's
        later versions exceed every adopted one. Returns how many were
        adopted."""
        events: List[Event] = []
        with self._lock:
            for obj in objs:
                table, key = self._table_key(
                    kind, obj.metadata.namespace, obj.metadata.name)
                rv = _int_rv(obj)
                cur = table.get(key)
                if cur is not None and _int_rv(cur) > rv:
                    continue
                table[key] = obj
                if kind == "Pod":
                    self._bound += (bool(obj.spec.node_name)
                                    - bool(cur is not None
                                           and cur.spec.node_name))
                self._rv = max(self._rv, rv)
                events.append(Event(MODIFIED, kind, obj))
            self._dispatch_silent(events)
        return len(events)

    def evict_objects(self, kind: str, keys: List[Tuple[str, str]]
                      ) -> List[Any]:
        """Remove (namespace, name) objects with no watch event: the
        source half of a slice move. Returns the evicted objects."""
        events: List[Event] = []
        out: List[Any] = []
        with self._lock:
            for namespace, name in keys:
                table, key = self._table_key(kind, namespace, name)
                obj = table.pop(key, None)
                if obj is not None:
                    if kind == "Pod":
                        self._bound -= bool(obj.spec.node_name)
                    out.append(obj)
                    events.append(Event(DELETED, kind, obj))
            self._dispatch_silent(events)
        return out

    def apply_replicated(self, events: List[Event]) -> List[Event]:
        """Apply another store's committed events with their
        resourceVersions kept: the read tier's mirror ingest
        (``apiserver/readtier.py``). Unlike ``adopt_objects`` the applied
        events are dispatched, commit stamps included, so a replica's
        watchers see the owner's history verbatim. An event not newer
        than the stored object (a resumed subscription's overlap) is
        dropped, so the replica's history holds no duplicate. A DELETED
        event may carry a key-only stub (a delete replayed from the WAL
        has no body): the stored object is popped and announced at the
        delete's version. Returns the applied events."""
        applied: List[Event] = []
        with self._lock:
            for e in events:
                try:
                    table, key = self._table_key(
                        e.kind, getattr(e.obj.metadata, "namespace", ""),
                        e.obj.metadata.name)
                except KeyError:
                    continue   # a kind this mirror does not store
                rv = _int_rv(e.obj)
                cur = table.get(key)
                cur_rv = _int_rv(cur) if cur is not None else 0
                if e.type == DELETED:
                    if cur is None or cur_rv > rv:
                        continue
                    table.pop(key, None)
                    if e.kind == "Pod":
                        self._bound -= bool(cur.spec.node_name)
                    # the stored object at the delete's version, on a
                    # copy: committed events stay as they were
                    final = shallow_copy(cur)
                    final.metadata = shallow_copy(cur.metadata)
                    final.metadata.resource_version = str(rv)
                    e = Event(DELETED, e.kind, final, ts=e.ts,
                              origin=e.origin)
                else:
                    if cur is not None and cur_rv >= rv:
                        continue
                    table[key] = e.obj
                    if e.kind == "Pod":
                        self._bound += (bool(e.obj.spec.node_name)
                                        - bool(cur is not None
                                               and cur.spec.node_name))
                self._rv = max(self._rv, rv)
                applied.append(e)
            self._dispatch(applied)
        return applied

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
        resource version and one ADDED event per pod, and a creation
        time for a pod without one. The batch is
        validated whole first, so watchers see all of it or none."""
        with self._lock:
            seen = set()
            for pod in pods:
                key = pod.full_name()
                if key in self._pods or key in seen:
                    raise ValueError(f"pod {key} already exists")
                seen.add(key)
            events = []
            now = time.time()
            for pod in pods:
                if not pod.metadata.creation_timestamp:
                    pod.metadata.creation_timestamp = now
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

    def list_pods(self, namespace: Optional[str] = None) -> List[Pod]:
        with self._lock:
            if namespace is None:
                return list(self._pods.values())
            return [p for p in self._pods.values()
                    if p.namespace == namespace]

    def create_pod(self, pod: Pod) -> Pod:
        return self.create_pods([pod])[0]

    def set_pod_phase(self, namespace: str, name: str, phase: str,
                      pod_ip: str = "", host_ip: str = "") -> bool:
        """The kubelet's status write: phase and addresses on a fresh copy
        of the pod, one MODIFIED event. False when the pod is gone."""
        with self._lock:
            key = f"{namespace}/{name}"
            pod = self._pods.get(key)
            if pod is None:
                return False
            new_pod = shallow_copy(pod)
            new_pod.status = shallow_copy(pod.status)
            if phase:
                new_pod.status.phase = phase
            if pod_ip:
                new_pod.status.pod_ip = pod_ip
            if host_ip:
                new_pod.status.host_ip = host_ip
            new_pod.metadata = shallow_copy(pod.metadata)
            new_pod.metadata.resource_version = self._next_rv()
            self._pods[key] = new_pod
            self._dispatch([Event(MODIFIED, "Pod", new_pod, pod)])
            return True

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
            # no event, but the object changed: the REST list cache
            # must not serve the old conditions
            self._bump_kind("Pod")

    def set_nominated_node_name(self, namespace: str, name: str,
                                node: str) -> None:
        with self._lock:
            pod = self._pods.get(f"{namespace}/{name}")
            if pod is not None:
                pod.status.nominated_node_name = node
                self._bump_kind("Pod")

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
    # PodDisruptionBudgets, and the controller objects SelectorSpread
    # reads (Services, ReplicationControllers, ReplicaSets, StatefulSets):
    # each create or replace is one ADDED or MODIFIED event
    def add_pdb(self, pdb: PodDisruptionBudget) -> None:
        with self._lock:
            pdb.metadata.resource_version = self._next_rv()
            self._pdbs[f"{pdb.namespace}/{pdb.name}"] = pdb
            self._bump_kind("PodDisruptionBudget")

    def list_pdbs(self) -> List[PodDisruptionBudget]:
        with self._lock:
            return list(self._pdbs.values())

    def add_service(self, svc: Service) -> None:
        self._upsert(self._services, "Service",
                     f"{svc.namespace}/{svc.name}", svc)

    def list_services(self, namespace: str) -> List[Service]:
        return self._in_namespace(self._services, namespace)

    def delete_service(self, namespace: str, name: str) -> None:
        self.delete_object("Service", namespace, name)

    def upsert_endpoints(self, ep: Endpoints) -> None:
        self._upsert(self._endpoints, "Endpoints",
                     f"{ep.namespace}/{ep.name}", ep)

    def delete_endpoints(self, namespace: str, name: str) -> None:
        self.delete_object("Endpoints", namespace, name)

    def get_endpoints(self, namespace: str, name: str
                      ) -> Optional[Endpoints]:
        with self._lock:
            return self._endpoints.get(f"{namespace}/{name}")

    def list_endpoints(self) -> List[Endpoints]:
        with self._lock:
            return list(self._endpoints.values())

    def add_replication_controller(self, rc: ReplicationController) -> None:
        self._upsert(self._rcs, "ReplicationController",
                     f"{rc.namespace}/{rc.name}", rc)

    def list_replication_controllers(self, namespace: str
                                     ) -> List[ReplicationController]:
        return self._in_namespace(self._rcs, namespace)

    def add_replica_set(self, rs: ReplicaSet) -> None:
        self._upsert(self._rss, "ReplicaSet", f"{rs.namespace}/{rs.name}", rs)

    def list_replica_sets(self, namespace: str) -> List[ReplicaSet]:
        return self._in_namespace(self._rss, namespace)

    def add_stateful_set(self, ss: StatefulSet) -> None:
        self._upsert(self._sss, "StatefulSet", f"{ss.namespace}/{ss.name}",
                     ss)

    def list_stateful_sets(self, namespace: str) -> List[StatefulSet]:
        return self._in_namespace(self._sss, namespace)

    def _in_namespace(self, table: Dict, namespace: str) -> List:
        with self._lock:
            return [o for o in table.values()
                    if o.metadata.namespace == namespace]

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

    # ------------------------------------------------------------------
    # the tables RBAC and admission read
    def add_role(self, r: Role) -> None:
        self._upsert(self._roles, "Role", f"{r.namespace}/{r.name}", r)

    def get_role(self, namespace: str, name: str) -> Optional[Role]:
        with self._lock:
            return self._roles.get(f"{namespace}/{name}")

    def list_roles(self, namespace: Optional[str] = None) -> List[Role]:
        with self._lock:
            return [r for r in self._roles.values()
                    if namespace is None or r.namespace == namespace]

    def add_cluster_role(self, r: ClusterRole) -> None:
        self._upsert(self._cluster_roles, "ClusterRole", r.name, r)

    def get_cluster_role(self, name: str) -> Optional[ClusterRole]:
        with self._lock:
            return self._cluster_roles.get(name)

    def list_cluster_roles(self) -> List[ClusterRole]:
        with self._lock:
            return list(self._cluster_roles.values())

    def add_role_binding(self, rb: RoleBinding) -> None:
        self._upsert(self._role_bindings, "RoleBinding",
                     f"{rb.namespace}/{rb.name}", rb)

    def list_role_bindings(self, namespace: Optional[str] = None
                           ) -> List[RoleBinding]:
        with self._lock:
            return [rb for rb in self._role_bindings.values()
                    if namespace is None or rb.namespace == namespace]

    def add_cluster_role_binding(self, crb: ClusterRoleBinding) -> None:
        self._upsert(self._cluster_role_bindings, "ClusterRoleBinding",
                     crb.name, crb)

    def list_cluster_role_bindings(self) -> List[ClusterRoleBinding]:
        with self._lock:
            return list(self._cluster_role_bindings.values())

    def add_namespace(self, ns: Namespace) -> None:
        self._upsert(self._namespaces, "Namespace", ns.name, ns)

    def get_namespace(self, name: str) -> Optional[Namespace]:
        """Read without the lock (one dict read is atomic): admission
        calls it for every item of a bulk create, and the lock's queue
        under bulk abuse would cost each item a writer's whole turn."""
        return self._namespaces.get(name)

    def list_namespaces(self) -> List[Namespace]:
        with self._lock:
            return list(self._namespaces.values())

    def add_resource_quota(self, quota: ResourceQuota) -> None:
        self._upsert(self._quotas, "ResourceQuota",
                     f"{quota.namespace}/{quota.name}", quota)

    def list_resource_quotas(self) -> List[ResourceQuota]:
        """Read without the lock (copying a dict's values is one atomic
        step): quota admission reads it for every pod of a bulk create."""
        return list(self._quotas.values())

    def list_priority_classes(self) -> List[Any]:
        """Read without the lock, as ``list_resource_quotas``: priority
        admission reads it for every pod without a priority."""
        return list(self._priority_classes.values())

    def add_service_account(self, sa: ServiceAccount) -> None:
        self._upsert(self._service_accounts, "ServiceAccount",
                     f"{sa.namespace}/{sa.name}", sa)

    def get_service_account(self, namespace: str, name: str
                            ) -> Optional[ServiceAccount]:
        with self._lock:
            return self._service_accounts.get(f"{namespace}/{name}")

    def list_all_services(self) -> List[Service]:
        with self._lock:
            return list(self._services.values())

    # ------------------------------------------------------------------
    # the generic verbs the REST server serves every kind through; pods
    # and nodes go through their own verbs, so the bound count and the
    # pod-copy-on-bind rule hold whichever way they are written
    _KIND_TABLES = {
        "Pod": ("_pods", True),
        "Node": ("_nodes", False),
        "Service": ("_services", True),
        "Endpoints": ("_endpoints", True),
        "ReplicaSet": ("_rss", True),
        "ReplicationController": ("_rcs", True),
        "StatefulSet": ("_sss", True),
        "PersistentVolumeClaim": ("_pvcs", True),
        "PersistentVolume": ("_pvs", False),
        "StorageClass": ("_storage_classes", False),
        "CSINode": ("_csi_nodes", False),
        "PodDisruptionBudget": ("_pdbs", True),
        "Event": ("_api_events", True),
        "Namespace": ("_namespaces", False),
        "ResourceQuota": ("_quotas", True),
        "ServiceAccount": ("_service_accounts", True),
        "Role": ("_roles", True),
        "ClusterRole": ("_cluster_roles", False),
        "RoleBinding": ("_role_bindings", True),
        "ClusterRoleBinding": ("_cluster_role_bindings", False),
        "Secret": ("_secrets", True),
        "ConfigMap": ("_config_maps", True),
        "PriorityClass": ("_priority_classes", False),
    }

    def _kind_entry(self, kind: str) -> Tuple[Dict[str, Any], bool]:
        """(table, namespaced) of a kind; KeyError for one not stored."""
        entry = self._KIND_TABLES.get(kind)
        if entry is None:
            raise KeyError(f"unknown kind {kind!r}")
        return getattr(self, entry[0]), entry[1]

    def _table_key(self, kind: str, namespace: str, name: str):
        table, namespaced = self._kind_entry(kind)
        return table, (f"{namespace}/{name}" if namespaced else name)

    def kind_is_namespaced(self, kind: str) -> bool:
        return self._kind_entry(kind)[1]

    def known_kinds(self) -> List[str]:
        return list(self._KIND_TABLES)

    def current_rv(self) -> int:
        with self._lock:
            return self._rv

    def create_object(self, kind: str, obj) -> Any:
        """Create one object; ValueError when its key is taken."""
        with self._lock:
            table, key = self._table_key(kind, obj.metadata.namespace,
                                         obj.metadata.name)
            if key in table:
                raise ValueError(f"{kind} {key!r} already exists")
            if kind == "Pod":
                return self.create_pod(obj)
            if not obj.metadata.creation_timestamp:
                obj.metadata.creation_timestamp = time.time()
            obj.metadata.resource_version = self._next_rv()
            table[key] = obj
            self._dispatch([Event(ADDED, kind, obj)])
            return obj

    def create_objects_bulk(self, kind: str, objs: List[Any]) -> int:
        """Create many objects of one kind under one lock and one watch
        delivery; a taken name is skipped. Returns how many were
        created."""
        if kind == "Event":
            return self.create_events(objs)
        return sum(e is None for e in self.create_objects_each(kind, objs))

    def create_objects_each(self, kind: str, objs: List[Any]
                            ) -> List[Optional[str]]:
        """``create_object`` for each object, under one lock and one watch
        delivery: the error of each, None where it was created (a taken
        name, or one taken earlier in ``objs``, is an error)."""
        events: List[Event] = []
        errors: List[Optional[str]] = []
        with self._lock:
            for obj in objs:
                table, key = self._table_key(
                    kind, obj.metadata.namespace, obj.metadata.name)
                if key in table:
                    errors.append(f"{kind} {key!r} already exists")
                    continue
                if not obj.metadata.creation_timestamp:
                    obj.metadata.creation_timestamp = time.time()
                obj.metadata.resource_version = self._next_rv()
                table[key] = obj
                if kind == "Pod":
                    self._bound += bool(obj.spec.node_name)
                events.append(Event(ADDED, kind, obj))
                errors.append(None)
            self._dispatch(events)
        return errors

    def update_object(self, kind: str, obj,
                      expect_rv: Optional[str] = None) -> Any:
        """Replace a stored object (a MODIFIED event): KeyError when it is
        missing, ``ConflictError`` when ``expect_rv`` is given and is not
        its resourceVersion."""
        with self._lock:
            table, key = self._table_key(kind, obj.metadata.namespace,
                                         obj.metadata.name)
            old = table.get(key)
            if old is None:
                raise KeyError(f"{kind} {key!r} not found")
            if expect_rv and old.metadata.resource_version != expect_rv:
                raise ConflictError(
                    f"{kind} {key!r}: resourceVersion conflict "
                    f"(have {old.metadata.resource_version}, "
                    f"want {expect_rv})")
            obj.metadata.resource_version = self._next_rv()
            table[key] = obj
            if kind == "Pod":
                self._bound += (bool(obj.spec.node_name)
                                - bool(old.spec.node_name))
            self._dispatch([Event(MODIFIED, kind, obj, old)])
            return obj

    def mutate_object(self, kind: str, namespace: str, name: str,
                      mutate: Callable[[Any], Any], retries: int = 8):
        """Read, modify, write with a resourceVersion precondition:
        ``mutate`` edits a copy (metadata and status copied too) and may
        return False to write nothing; a conflicting writer costs a
        retry, not a lost field. Returns the stored object, or None when
        it is missing or ``mutate`` declined; ``ConflictError`` once
        ``retries`` are spent."""
        for _ in range(retries):
            current = self.get_object(kind, namespace, name)
            if current is None:
                return None
            updated = shallow_copy(current)
            updated.metadata = shallow_copy(current.metadata)
            if hasattr(current, "status"):
                updated.status = shallow_copy(current.status)
            if mutate(updated) is False:
                return None
            try:
                return self.update_object(
                    kind, updated,
                    expect_rv=current.metadata.resource_version)
            except ConflictError:
                continue
        raise ConflictError(
            f"{kind} {namespace}/{name}: mutate_object retries exhausted")

    def delete_object(self, kind: str, namespace: str, name: str) -> bool:
        """Delete one object (a DELETED event carrying a copy stamped with
        a new resourceVersion); False when it is not stored."""
        with self._lock:
            table, key = self._table_key(kind, namespace, name)
            old = table.pop(key, None)
            if old is None:
                return False
            if kind == "Pod":
                self._bound -= bool(old.spec.node_name)
            self._dispatch([Event(DELETED, kind, self._deletion_copy(old))])
            return True

    def _lease_object(self, name: str, lease: "_Lease") -> Lease:
        """The read-only view of an internal lease (kube-system)."""
        return Lease(metadata=ObjectMeta(name=name, namespace="kube-system"),
                     holder_identity=lease.holder,
                     lease_duration_seconds=lease.duration,
                     renew_time=lease.renew_time)

    def get_object(self, kind: str, namespace: str, name: str):
        if kind == "Lease":
            if namespace not in ("", "kube-system"):
                return None
            with self._lock:
                lease = self._leases.get(name)
                return (self._lease_object(name, lease)
                        if lease is not None else None)
        with self._lock:
            table, key = self._table_key(kind, namespace, name)
            return table.get(key)

    def list_objects(self, kind: str, namespace: Optional[str] = None
                     ) -> List[Any]:
        return self.list_objects_with_rv(kind, namespace)[0]

    def list_objects_with_rv(self, kind: str,
                             namespace: Optional[str] = None
                             ) -> Tuple[List[Any], int]:
        """A list and the resourceVersion it is consistent at, taken
        together: a watch from that version misses nothing the list
        lacks."""
        if kind == "Lease":
            with self._lock:
                if namespace is not None and namespace != "kube-system":
                    return [], self._rv
                return [self._lease_object(name, lease)
                        for name, lease in sorted(self._leases.items())
                        ], self._rv
        with self._lock:
            table, namespaced = self._kind_entry(kind)
            objs = list(table.values())
            if namespace is not None and namespaced:
                objs = [o for o in objs if o.metadata.namespace == namespace]
            return objs, self._rv

    def recount_locked(self) -> None:
        """Recompute the bound-pod count after the tables were written
        directly (a WAL restore); the lock is held."""
        self._bound = sum(1 for p in self._pods.values() if p.spec.node_name)

    # ------------------------------------------------------------------
    # leases (leader election): a holder renews its own lease; another
    # candidate takes it only once ``duration`` has passed since the
    # holder's last renewal
    def try_acquire_or_renew(self, name: str, holder: str, now: float,
                             duration: float) -> bool:
        with self._lock:
            lease = self._leases.get(name)
            if (lease is None or lease.holder == holder
                    or now - lease.renew_time > lease.duration):
                self._leases[name] = _Lease(holder, now, duration)
                return True
            return False

    def lease_holder(self, name: str) -> Optional[str]:
        with self._lock:
            lease = self._leases.get(name)
            return lease.holder if lease else None

    def lease_info(self, name: str) -> Optional[Tuple[str, float]]:
        """(holder, last renewal time) of the lease, or None; the lease
        is left as it is."""
        with self._lock:
            lease = self._leases.get(name)
            return (lease.holder, lease.renew_time) if lease else None


def _int_rv(obj) -> int:
    try:
        return int(obj.metadata.resource_version or 0)
    except (TypeError, ValueError):
        return 0


class _SilentHandle:
    def __init__(self, store: ClusterStore, fn):
        self._store, self._fn = store, fn

    def stop(self) -> None:
        with self._store._lock:
            if self._fn in self._store._silent_sinks:
                self._store._silent_sinks.remove(self._fn)


class _Lease:
    __slots__ = ("holder", "renew_time", "duration")

    def __init__(self, holder: str, renew_time: float, duration: float):
        self.holder = holder
        self.renew_time = renew_time
        self.duration = duration


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
SERVICE_EVENTS = {ADDED: q.SERVICE_ADD, MODIFIED: q.SERVICE_UPDATE}


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
    there.

    Services: an add or an update wakes parked pods (ServiceAffinity and
    SelectorSpread read them).

    A replica of a set (``scheduler.replicas``) queues only the pending
    pods its ``pod_shard`` accepts, and caches only the nodes its
    ``node_shard`` accepts and the pods bound to them: a pod on another
    pool's node lies outside its snapshot either way, and caching it
    would only make the device mirror rebuild after each sibling's
    bind."""

    def __init__(self, scheduler):
        self.sched = scheduler

    def responsible_for(self, pod: Pod) -> bool:
        """The pod's profile is one this scheduler runs and, for a replica
        of a set, its hash falls to this replica."""
        if pod.spec.scheduler_name not in self.sched.profiles:
            return False
        shard = self.sched.pod_shard
        return shard is None or shard(pod)

    def caches_node(self, name: str) -> bool:
        """The node is in this replica's pool (every node, outside a
        node-sharded set)."""
        shard = self.sched.node_shard
        return shard is None or shard(name)

    def handle_many(self, events: List[Event]) -> None:
        sched = self.sched
        if any(e.kind != "Event" for e in events):
            # the newest commit the batch carries (the in-process store
            # delivers at its commit, a remote client later); unstamped
            # events count as committed now
            sched.cache.note_event_ts(
                max(e.ts for e in events if e.kind != "Event")
                or time.time())
        bind_run: List[Pod] = []    # pods newly assigned
        add_run: List[Pod] = []     # pending pods added
        delete_run: List[Pod] = []  # assigned pods deleted
        runs = (bind_run, add_run, delete_run)

        def flush():
            if bind_run:
                cached = [p for p in bind_run
                          if self.caches_node(p.spec.node_name)]
                sched.cache.add_pods(cached)
                sched.queue.delete_many(bind_run)
                sched.queue.assigned_pods_updated(cached)
                bind_run.clear()
            if add_run:
                sched.queue.add_many(add_run)
                sched.queue.gang_members_added({
                    g for p in add_run
                    if (g := p.metadata.labels.get(GROUP_NAME_LABEL))})
                add_run.clear()
            if delete_run:
                for pod in delete_run:
                    # a no-op for another pool's pod, never cached
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
        elif event.kind == "Service":
            name = SERVICE_EVENTS.get(event.type)
            if name:
                self.sched.queue.move_all_to_active_or_backoff_queue(name)

    def _handle_pod(self, event: Event) -> None:
        sched = self.sched
        pod, old = event.obj, event.old_obj
        if assigned(pod) and not self.caches_node(pod.spec.node_name):
            if event.type == MODIFIED and old is not None \
                    and not assigned(old):
                sched.queue.delete(pod)
            return   # bound in another replica's pool
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
                for fwk in sched.profiles.values():
                    fwk.reject_waiting_pod(pod.uid)

    def _gang_member_deleted(self, pod: Pod) -> None:
        if pod.metadata.labels.get(GROUP_NAME_LABEL):
            for fwk in self.sched.profiles.values():
                gang = fwk.get_plugin("Coscheduling")
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
        if not self.caches_node(node.name):
            return   # another replica's pool
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
