"""ReplicaSet and ReplicationController reconcile loops.

The reference's ``pkg/controller/replicaset/replica_set.go``
(syncReplicaSet): list the pods the owner controls, adopt matching
orphans, and create or delete the difference from ``spec.replicas``. The
ReplicationController is the same loop over the older kind, as the
reference builds it on the ReplicaSet controller
(``pkg/controller/replication``).
"""

from __future__ import annotations

import copy

from kubernetes_tpu_torch.api.labels import LabelSelector
from kubernetes_tpu_torch.api.types import (
    FAILED,
    SUCCEEDED,
    Pod,
    ReplicaSet,
    WorkloadStatus,
)
from kubernetes_tpu_torch.controllers.base import (
    Controller,
    controller_of,
    is_owned_by,
    owner_ref,
    split_key,
    with_status,
)


def _is_active(pod: Pod) -> bool:
    """Neither terminal nor being deleted (controller.FilterActivePods)."""
    return (pod.status.phase not in (SUCCEEDED, FAILED)
            and pod.metadata.deletion_timestamp is None)


class _ReplicaWorkloadController(Controller):
    """The shared loop; a subclass names the kind and its store verbs."""

    kind = ""

    def register(self) -> None:
        self.factory.informer_for(self.kind).add_event_handler(
            on_add=self.enqueue,
            on_update=lambda old, new: self.enqueue(new),
            on_delete=self.enqueue,
        )
        self.factory.informer_for("Pod").add_event_handler(
            on_add=self._pod_changed,
            on_update=lambda old, new: self._pod_changed(new),
            on_delete=self._pod_changed,
        )
        self.pod_lister = self.factory.lister_for("Pod")
        self.lister = self.factory.lister_for(self.kind)

    def _pod_changed(self, pod: Pod) -> None:
        ref = controller_of(pod)
        if ref is not None and ref.get("kind") == self.kind:
            self.enqueue_key(f"{pod.namespace}/{ref['name']}")

    def _get(self, namespace: str, name: str):
        raise NotImplementedError

    def _selector_matches(self, owner, pod: Pod) -> bool:
        raise NotImplementedError

    def _update_status(self, owner) -> None:
        raise NotImplementedError

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        owner = self._get(ns, name)
        if owner is None:
            return
        owned, orphans = [], []
        for p in self.pod_lister.by_namespace(ns):
            if is_owned_by(p, self.kind, owner):
                owned.append(p)
            elif controller_of(p) is None and self._selector_matches(owner, p):
                orphans.append(p)
        # adopted orphans' later events route back here (ClaimPods)
        pods = owned + [self._adopt(p, owner) for p in orphans]
        active = [p for p in pods if _is_active(p)]
        diff = owner.replicas - len(active)
        if diff > 0:
            for i in range(diff):
                self._create_pod(owner)
        elif diff < 0:
            # unassigned first, then the newest (controller_utils.go's
            # ActivePods order)
            victims = sorted(active, key=lambda p: (
                bool(p.spec.node_name), -p.metadata.creation_timestamp))
            for p in victims[:-diff]:
                self.store.delete_pod(p.namespace, p.name)
        status = WorkloadStatus(
            replicas=len(active) + max(diff, 0),
            ready_replicas=sum(1 for p in active if p.spec.node_name))
        # write only a changed status: each write is an event that would
        # queue this owner again
        if status != owner.status:
            self._update_status(with_status(owner, status))

    def _adopt(self, pod: Pod, owner) -> Pod:
        adopted = copy.copy(pod)
        adopted.metadata = copy.copy(pod.metadata)
        adopted.metadata.owner_references = (
            list(pod.metadata.owner_references) + [owner_ref(self.kind, owner)])
        self.store.update_pod(adopted)
        return adopted

    def _create_pod(self, owner) -> None:
        template = dict(owner.template or {})
        pod = Pod.from_dict(template)
        pod.metadata.namespace = owner.metadata.namespace
        base = (template.get("metadata", {}).get("generateName")
                or f"{owner.metadata.name}-")
        pod.metadata.name = f"{base}{pod.metadata.uid}"
        pod.metadata.owner_references = (
            list(pod.metadata.owner_references) + [owner_ref(self.kind, owner)])
        self.store.create_pod(pod)


class ReplicaSetController(_ReplicaWorkloadController):
    name = "replicaset"
    kind = "ReplicaSet"

    def _get(self, namespace: str, name: str):
        return self.store.get_replica_set(namespace, name)

    def _selector_matches(self, rs: ReplicaSet, pod: Pod) -> bool:
        return (rs.selector is not None
                and rs.selector.to_selector().matches(pod.metadata.labels))

    def _update_status(self, rs: ReplicaSet) -> None:
        self.store.update_replica_set(rs)


class ReplicationController(_ReplicaWorkloadController):  # noqa: N801 — the kind's name
    name = "replicationcontroller"
    kind = "ReplicationController"

    def _get(self, namespace: str, name: str):
        for rc in self.store.list_all_replication_controllers():
            if rc.metadata.namespace == namespace and rc.metadata.name == name:
                return rc
        return None

    def _selector_matches(self, rc, pod: Pod) -> bool:
        return bool(rc.selector) and LabelSelector(
            match_labels=dict(rc.selector)).to_selector().matches(
                pod.metadata.labels)

    def _update_status(self, rc) -> None:
        self.store.add_replication_controller(rc)
