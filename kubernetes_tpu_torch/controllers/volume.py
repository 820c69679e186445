"""PersistentVolume binder controller.

The reference's PV controller
(``pkg/controller/volume/persistentvolume/pv_controller.go``) in the
shape scheduler_perf runs it (``test/integration/scheduler_perf/util.go``
StartFakePVController): a pending claim of an Immediate class is bound to
an Available PV of its class, access modes and capacity; a
WaitForFirstConsumer claim is left to the scheduler's VolumeBinding
plugin.
"""

from __future__ import annotations

from kubernetes_tpu_torch.api.types import (
    PersistentVolume,
    PersistentVolumeClaim,
)
from kubernetes_tpu_torch.controllers.base import Controller, split_key


class PersistentVolumeController(Controller):
    name = "persistentvolume-binder"

    def register(self) -> None:
        self.factory.informer_for("PersistentVolumeClaim").add_event_handler(
            on_add=self.enqueue,
            on_update=lambda old, new: self.enqueue(new),
        )
        self.factory.informer_for("PersistentVolume").add_event_handler(
            on_add=lambda pv: self._all_pending_pvcs(),
        )
        self.pvc_lister = self.factory.lister_for("PersistentVolumeClaim")

    def _all_pending_pvcs(self) -> None:
        for pvc in self.store.list_all_pvcs():
            if pvc.phase == "Pending":
                self.enqueue(pvc)

    def _binding_mode(self, pvc: PersistentVolumeClaim) -> str:
        if not pvc.storage_class_name:
            return "Immediate"
        sc = self.store.get_storage_class(pvc.storage_class_name)
        return sc.volume_binding_mode if sc else "Immediate"

    @staticmethod
    def _matches(pv: PersistentVolume, pvc: PersistentVolumeClaim) -> bool:
        if pv.phase != "Available" or pv.claim_ref:
            return False
        if pv.storage_class_name != (pvc.storage_class_name or ""):
            return False
        if pvc.access_modes and not set(pvc.access_modes) <= set(
                pv.access_modes):
            return False
        want = pvc.requests.get("storage")
        have = pv.capacity.get("storage")
        return want is None or (have is not None and have.nano >= want.nano)

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        pvc = self.store.get_pvc(ns, name)
        if pvc is None or pvc.phase != "Pending" \
                or self._binding_mode(pvc) != "Immediate":
            return
        for pv in self.store.list_pvs():
            if self._matches(pv, pvc):
                self.store.bind_pv(pv.name, ns, name)
                return
