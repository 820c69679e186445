"""Attach/detach controller.

The reference's ``pkg/controller/volume/attachdetach`` (the controller
and its reconciler): each node's ``status.volumesAttached`` lists the PVs
behind the bound claims of the pods placed on it, and a volume whose last
consumer left is detached (removed).

As the reference's desired state of the world (``attachdetach/cache``),
pod and claim events update per-node maps in the event's own cost rather
than rescanning every pod a sync; a slow resync rebuilds them from the
store. Node writes go through the store's resourceVersion-checked mutate
loop, so another writer of node status loses nothing, and a volume the
kubelet still reports in ``status.volumesInUse`` stays attached (the
reference's safe-detach interlock; its six-minute forced detach is not
modelled).
"""

from __future__ import annotations

import threading
from typing import Dict, Set

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.controllers.base import Controller


class AttachDetachController(Controller):
    name = "attachdetach"

    # the rebuild's period (the reference's reconciler loops every 100 ms
    # against its cloud; state the API shows needs only a slow backstop)
    RESYNC_SECONDS = 30.0

    def register(self) -> None:
        self._dsw_lock = threading.Lock()
        # node -> pod key -> the claims it references ("ns/claim")
        self._dsw: Dict[str, Dict[str, Set[str]]] = {}
        # claim key -> the nodes with a consumer of it
        self._claim_nodes: Dict[str, Set[str]] = {}
        self.factory.informer_for("Pod").add_event_handler(
            on_add=self._pod_upsert,
            on_update=lambda old, new: self._pod_update(old, new),
            on_delete=self._pod_delete,
        )
        # a claim may arrive bound (ADDED), bind again (MODIFIED) or go
        # (DELETED)
        self.factory.informer_for("PersistentVolumeClaim").add_event_handler(
            on_add=self._pvc_changed,
            on_update=lambda old, new: self._pvc_changed(new),
            on_delete=self._pvc_changed,
        )
        # a kubelet's unmount report may free a detach now, not at the
        # next resync
        self.factory.informer_for("Node").add_event_handler(
            on_update=lambda old, new: (
                self.enqueue_key(new.name)
                if old is not None
                and old.status.volumes_in_use != new.status.volumes_in_use
                else None),
        )

    @staticmethod
    def _claims_of(pod: Pod) -> Set[str]:
        return {f"{pod.namespace}/{v.persistent_volume_claim}"
                for v in pod.spec.volumes if v.persistent_volume_claim}

    def _pod_upsert(self, pod: Pod) -> None:
        if not pod.spec.node_name:
            return
        claims = self._claims_of(pod)
        node = pod.spec.node_name
        key = pod.full_name()
        with self._dsw_lock:
            if claims and pod.status.phase not in ("Succeeded", "Failed"):
                self._dsw.setdefault(node, {})[key] = claims
                for c in claims:
                    self._claim_nodes.setdefault(c, set()).add(node)
            else:
                self._dsw.get(node, {}).pop(key, None)
        self.enqueue_key(node)

    def _pod_update(self, old: Pod, new: Pod) -> None:
        if old is not None and old.spec.node_name and \
                old.spec.node_name != new.spec.node_name:
            self._pod_delete(old)
        self._pod_upsert(new)

    def _pod_delete(self, pod: Pod) -> None:
        if not pod.spec.node_name:
            return
        with self._dsw_lock:
            self._dsw.get(pod.spec.node_name, {}).pop(pod.full_name(), None)
        self.enqueue_key(pod.spec.node_name)

    def _pvc_changed(self, pvc) -> None:
        key = f"{pvc.namespace}/{pvc.name}"
        with self._dsw_lock:
            nodes = list(self._claim_nodes.get(key, ()))
        for node in nodes:
            self.enqueue_key(node)

    def resync(self) -> None:
        """Rebuild the maps in one pass over the pods and queue every node
        whose attachments could have drifted."""
        dsw: Dict[str, Dict[str, Set[str]]] = {}
        claim_nodes: Dict[str, Set[str]] = {}
        for p in self.store.list_pods():
            if not p.spec.node_name or \
                    p.status.phase in ("Succeeded", "Failed"):
                continue
            claims = self._claims_of(p)
            if not claims:
                continue
            dsw.setdefault(p.spec.node_name, {})[p.full_name()] = claims
            for c in claims:
                claim_nodes.setdefault(c, set()).add(p.spec.node_name)
        with self._dsw_lock:
            stale = set(self._dsw) | set(dsw)
            self._dsw = dsw
            self._claim_nodes = claim_nodes
        for node in stale:
            self.enqueue_key(node)

    def _desired_attached(self, node_name: str) -> Set[str]:
        """The PVs behind the node's consumed, bound claims."""
        with self._dsw_lock:
            claims = {c for per_pod in self._dsw.get(node_name, {}).values()
                      for c in per_pod}
        wanted: Set[str] = set()
        for claim in claims:
            ns, _, name = claim.partition("/")
            pvc = self.store.get_pvc(ns, name)
            if pvc is not None and pvc.volume_name:
                wanted.add(pvc.volume_name)
        return wanted

    def sync(self, key: str) -> None:
        if self.store.get_node(key) is None:
            with self._dsw_lock:
                self._dsw.pop(key, None)
            return
        wanted = self._desired_attached(key)

        def mutate(n) -> bool:
            # a volume the kubelet still reports in use stays attached
            # with no consumer left
            attached = set(n.status.volumes_attached)
            new = sorted(wanted | (attached & set(n.status.volumes_in_use)))
            if new == n.status.volumes_attached:
                return False
            n.status.volumes_attached = new
            return True

        self.store.mutate_object("Node", "", key, mutate)
