"""Endpoints reconcile loop.

The reference's ``pkg/controller/endpoint/endpoints_controller.go``: for
every Service, an Endpoints object listing the addresses of the bound,
live pods its selector matches (kube-proxy's input).
"""

from __future__ import annotations

from kubernetes_tpu_torch.api.types import (
    FAILED,
    SUCCEEDED,
    EndpointAddress,
    Endpoints,
    Pod,
    Service,
)
from kubernetes_tpu_torch.controllers.base import Controller, split_key


class EndpointsController(Controller):
    name = "endpoints"

    def register(self) -> None:
        self.factory.informer_for("Service").add_event_handler(
            on_add=self.enqueue,
            on_update=lambda old, new: self.enqueue(new),
            on_delete=self.enqueue,
        )
        self.factory.informer_for("Pod").add_event_handler(
            on_add=self._pod_changed,
            # both sides: a label change resyncs the service the pod left
            # as well as the one it joined
            on_update=lambda old, new: (self._pod_changed(old),
                                        self._pod_changed(new)),
            on_delete=self._pod_changed,
        )
        self.pod_lister = self.factory.lister_for("Pod")
        self.svc_lister = self.factory.lister_for("Service")

    def _pod_changed(self, pod: Pod) -> None:
        for svc in self.svc_lister.by_namespace(pod.namespace):
            if self._selects(svc, pod):
                self.enqueue(svc)

    @staticmethod
    def _selects(svc: Service, pod: Pod) -> bool:
        return bool(svc.selector) and all(
            pod.metadata.labels.get(k) == v for k, v in svc.selector.items())

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        svc = next((s for s in self.store.list_all_services()
                    if s.metadata.namespace == ns
                    and s.metadata.name == name), None)
        if svc is None:
            self.store.delete_endpoints(ns, name)
            return
        addresses = [
            EndpointAddress(ip=pod.status.pod_ip or pod.full_name(),
                            node_name=pod.spec.node_name,
                            target_pod=pod.full_name())
            for pod in self.pod_lister.by_namespace(ns)
            if self._selects(svc, pod) and pod.spec.node_name
            and pod.status.phase not in (SUCCEEDED, FAILED)
            and pod.metadata.deletion_timestamp is None]
        ep = Endpoints(addresses=sorted(addresses, key=lambda a: a.target_pod),
                       ports=list(svc.ports))
        ep.metadata.name = name
        ep.metadata.namespace = ns
        # no write where nothing changed: each would be a MODIFIED event to
        # every watcher, on every pod event of every selecting service
        old = self.store.get_endpoints(ns, name)
        if old is not None and old.addresses == ep.addresses \
                and old.ports == ep.ports:
            return
        self.store.upsert_endpoints(ep)
