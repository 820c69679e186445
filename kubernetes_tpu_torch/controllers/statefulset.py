"""StatefulSet reconcile loop.

The reference's ``pkg/controller/statefulset/stateful_set_control.go``
with OrderedReady pod management: pods are named ``{set}-{ordinal}`` and
created in ordinal order, each once its predecessor is ready; a scale-down
deletes the highest ordinal first, one a sync. Ready is bound or Running:
without kubelets, a bind is the finish line.
"""

from __future__ import annotations

from kubernetes_tpu_torch.api.types import (
    RUNNING,
    Pod,
    StatefulSet,
    WorkloadStatus,
)
from kubernetes_tpu_torch.controllers.base import (
    Controller,
    owner_ref,
    split_key,
    with_status,
)


def _ready(pod: Pod) -> bool:
    return bool(pod.spec.node_name) or pod.status.phase == RUNNING


class StatefulSetController(Controller):
    name = "statefulset"

    def register(self) -> None:
        self.factory.informer_for("StatefulSet").add_event_handler(
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

    def _pod_changed(self, pod: Pod) -> None:
        for r in pod.metadata.owner_references:
            if r.get("controller") and r.get("kind") == "StatefulSet":
                self.enqueue_key(f"{pod.namespace}/{r['name']}")

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        sset = next((s for s in self.store.list_all_stateful_sets()
                     if s.metadata.namespace == ns
                     and s.metadata.name == name), None)
        if sset is None:
            return
        # ordinal -> pod from one listing, which also finds an ordinal
        # stranded past a gap after a scale-down race
        prefix = f"{name}-"
        pods = {i: None for i in range(max(sset.replicas, 0))}
        for p in self.store.list_pods(ns):
            suffix = p.name[len(prefix):]
            if not p.name.startswith(prefix) or not suffix.isdigit():
                continue
            refs = p.metadata.owner_references
            if refs and not any(r.get("kind") == "StatefulSet"
                                and r.get("name") == name for r in refs):
                continue  # the same prefix, another owner
            pods[int(suffix)] = p
        existing = [i for i, p in pods.items() if p is not None]
        if existing and max(existing) >= sset.replicas:
            top = max(existing)
            self.store.delete_pod(ns, f"{name}-{top}")
            status = WorkloadStatus(replicas=len(existing) - 1,
                                    ready_replicas=sset.status.ready_replicas)
            if status != sset.status:
                self.store.add_stateful_set(with_status(sset, status))
            return
        # the first missing ordinal, once every one before it is ready
        for i in range(sset.replicas):
            p = pods.get(i)
            if p is None:
                self._create_pod(sset, i)
                break
            if not _ready(p):
                break
        live = [p for p in pods.values() if p is not None]
        status = WorkloadStatus(replicas=len(live),
                                ready_replicas=sum(1 for p in live if _ready(p)))
        if status != sset.status:
            self.store.add_stateful_set(with_status(sset, status))

    def _create_pod(self, sset: StatefulSet, ordinal: int) -> None:
        pod = Pod.from_dict(dict(sset.template or {}))
        pod.metadata.namespace = sset.metadata.namespace
        pod.metadata.name = f"{sset.metadata.name}-{ordinal}"
        pod.metadata.owner_references = (
            list(pod.metadata.owner_references)
            + [owner_ref("StatefulSet", sset)])
        self.store.create_pod(pod)
