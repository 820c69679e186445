"""Ephemeral-volume controller (the reference's
``pkg/controller/volume/ephemeral/controller.go``): a pod volume with
``ephemeral`` set stands for a claim named ``<pod>-<volume>`` that the
pod owns; this loop makes the claim where it is missing (the owner
reference lets the garbage collector take it with the pod).
"""

from __future__ import annotations

from kubernetes_tpu_torch.api.resource import parse_quantity
from kubernetes_tpu_torch.api.types import ObjectMeta, PersistentVolumeClaim
from kubernetes_tpu_torch.controllers.base import (
    Controller,
    owner_ref,
    split_key,
)


class EphemeralVolumeController(Controller):
    name = "ephemeral-volume"

    def register(self) -> None:
        self.factory.informer_for("Pod").add_event_handler(
            on_add=self.enqueue,
            on_update=lambda old, new: self.enqueue(new),
        )

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        pod = self.store.get_pod(ns, name)
        if pod is None or pod.metadata.deletion_timestamp is not None:
            return
        for vol in pod.spec.volumes:
            claim_name = f"{name}-{vol.name}"
            # an existing claim, the pod's or not, leaves nothing to make
            # (the reference reports one it does not own as a conflict)
            if not vol.ephemeral or \
                    self.store.get_pvc(ns, claim_name) is not None:
                continue
            self.store.add_pvc(PersistentVolumeClaim(
                metadata=ObjectMeta(name=claim_name, namespace=ns,
                                    owner_references=[owner_ref("Pod", pod)]),
                requests={"storage": parse_quantity("1Gi")},
                phase="Pending",
            ))
