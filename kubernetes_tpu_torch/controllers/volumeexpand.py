"""Volume expand controller (the reference's
``pkg/controller/volume/expand/expand_controller.go``): a bound claim
whose ``requests.storage`` grew past its PV's capacity has the PV resized
at once (there is no storage provider behind it); a smaller request
changes nothing, as volumes only grow.
"""

from __future__ import annotations

import logging

from kubernetes_tpu_torch.controllers.base import Controller, split_key

_logger = logging.getLogger(__name__)


class VolumeExpandController(Controller):
    name = "volumeexpand"

    def register(self) -> None:
        self.factory.informer_for("PersistentVolumeClaim").add_event_handler(
            on_add=self.enqueue,
            on_update=lambda old, new: self.enqueue(new),
        )

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        pvc = self.store.get_pvc(ns, name)
        if pvc is None or not pvc.volume_name:
            return
        want = pvc.requests.get("storage")
        pv = self.store.get_pv(pvc.volume_name)
        if want is None or pv is None:
            return
        have = pv.capacity.get("storage")
        if have is None or have.value() >= want.value():
            return

        def mutate(p) -> bool:
            cap = p.capacity.get("storage")
            if cap is not None and cap.value() >= want.value():
                return False
            p.capacity = dict(p.capacity)
            p.capacity["storage"] = want
            return True

        self.store.mutate_object("PersistentVolume", "", pvc.volume_name,
                                 mutate)
        _logger.info("expanded PV %s to %s", pvc.volume_name, want)
