"""ServiceAccount controller.

The reference's ``pkg/controller/serviceaccount``
(serviceaccounts_controller.go): every namespace that is not terminating
has the "default" ServiceAccount, made again when it is deleted.
"""

from __future__ import annotations

from kubernetes_tpu_torch.api.types import ObjectMeta, ServiceAccount
from kubernetes_tpu_torch.controllers.base import Controller


class ServiceAccountController(Controller):
    name = "serviceaccount"

    ACCOUNT = "default"

    def register(self) -> None:
        # keyed by the namespace's bare name
        self.factory.informer_for("Namespace").add_event_handler(
            on_add=lambda ns: self.enqueue_key(ns.name),
            on_update=lambda old, new: self.enqueue_key(new.name),
        )
        self.factory.informer_for("ServiceAccount").add_event_handler(
            on_delete=lambda sa: self.enqueue_key(sa.namespace),
        )

    def sync(self, key: str) -> None:
        namespace = self.store.get_namespace(key)
        if namespace is None or namespace.phase == "Terminating":
            return
        if self.store.get_service_account(key, self.ACCOUNT) is None:
            self.store.add_service_account(ServiceAccount(
                metadata=ObjectMeta(name=self.ACCOUNT, namespace=key)))
