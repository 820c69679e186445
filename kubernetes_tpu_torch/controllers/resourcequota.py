"""ResourceQuota controller.

The reference's ``pkg/controller/resourcequota``
(resource_quota_controller.go syncResourceQuota): each quota's
``status.used`` recomputed from the live pods of its namespace (the pod
count and the summed container requests) and published. Enforcement is
admission's (``apiserver/admission.py``'s ``ResourceQuotaAdmission``),
as the reference splits accounting from gatekeeping.

Usage keys are the reference evaluator's ``pods``, ``requests.cpu`` and
``requests.memory``; a quota that names ``cpu`` or ``memory`` gets them
under those names too.
"""

from __future__ import annotations

from kubernetes_tpu_torch.api.resource import Quantity, parse_quantity
from kubernetes_tpu_torch.api.types import FAILED, SUCCEEDED, Pod, shallow_copy
from kubernetes_tpu_torch.controllers.base import Controller, split_key


def compute_usage(pods) -> dict:
    """The usage of the pods that are not terminal (the reference's core
    evaluator leaves out Succeeded and Failed pods)."""
    n = cpu_milli = mem = 0
    for p in pods:
        if p.status.phase in (SUCCEEDED, FAILED):
            continue
        n += 1
        for c in p.spec.containers:
            req = c.resources.requests
            if "cpu" in req:
                cpu_milli += int(req["cpu"].milli_value())
            if "memory" in req:
                mem += int(req["memory"].value())
    return {"pods": parse_quantity(n),
            "requests.cpu": Quantity(cpu_milli * 10**6),
            "requests.memory": parse_quantity(mem)}


class ResourceQuotaController(Controller):
    name = "resourcequota"

    def register(self) -> None:
        self.factory.informer_for("ResourceQuota").add_event_handler(
            on_add=self.enqueue,
            on_update=lambda old, new: self.enqueue(new),
        )
        self.factory.informer_for("Pod").add_event_handler(
            on_add=self._pod_changed,
            on_update=lambda old, new: self._pod_changed(new),
            on_delete=self._pod_changed,
        )
        self.pod_lister = self.factory.lister_for("Pod")

    def _pod_changed(self, pod: Pod) -> None:
        for q in self.store.list_resource_quotas():
            if q.namespace == pod.namespace:
                self.enqueue(q)

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        quota = self.store.get_resource_quota(ns, name)
        if quota is None:
            return
        usage = compute_usage(self.pod_lister.by_namespace(ns))
        used = {k: v for k, v in usage.items() if k in quota.hard}
        for alias, full in (("cpu", "requests.cpu"),
                            ("memory", "requests.memory")):
            if alias in quota.hard:
                used[alias] = usage[full]
        if used == quota.used:
            return
        updated = shallow_copy(quota)
        updated.used = used
        self.store.update_object("ResourceQuota", updated)
