"""Namespace lifecycle controller.

The reference's ``pkg/controller/namespace``
(namespaced_resources_deleter.go): a namespace whose deletion was asked
for is marked Terminating, every namespaced object in it is deleted, and
the sweep requeues until it finds the namespace empty; then the namespace
itself is removed.
"""

from __future__ import annotations

from kubernetes_tpu_torch.api.types import Namespace
from kubernetes_tpu_torch.controllers.base import Controller


class NamespaceController(Controller):
    name = "namespace"

    def register(self) -> None:
        # cluster-scoped: keyed by the bare name
        self.factory.informer_for("Namespace").add_event_handler(
            on_add=lambda ns: self.enqueue_key(ns.name),
            on_update=lambda old, new: self.enqueue_key(new.name),
        )

    def sync(self, key: str) -> None:
        ns = self.store.get_namespace(key)
        if ns is None:
            return
        if ns.phase != "Terminating" and ns.metadata.deletion_timestamp is None:
            return
        if ns.phase != "Terminating":
            self.store.update_object(
                "Namespace", Namespace(metadata=ns.metadata, phase="Terminating"))
        # every namespaced kind the store holds (the reference asks
        # discovery); writers that bypass admission may still add, so the
        # sweep repeats until it deletes nothing
        remaining = 0
        for kind in self.store.known_kinds():
            if kind == "Namespace" or not self.store.kind_is_namespaced(kind):
                continue
            for obj in self.store.list_objects(kind, namespace=key):
                self.store.delete_object(kind, obj.metadata.namespace,
                                         obj.metadata.name)
                remaining += 1
        if remaining:
            self.queue.add_rate_limited(key)
            return
        self.store.delete_namespace(key)
