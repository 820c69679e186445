"""Kubelet volume manager: the desired/actual-state-of-world reconciler.

Behavioral equivalent of the reference's kubelet volume manager
(``pkg/kubelet/volumemanager/volume_manager.go:247 NewVolumeManager``;
reconciler ``pkg/kubelet/volumemanager/reconciler/reconciler.go:77``):

- **Desired state of world**: every pod admitted to this node together
  with the volumes its spec mounts (``populator/
  desired_state_of_world_populator.go``: findAndAddNewPods /
  findAndRemoveDeletedPods — here the kubelet's sync path adds and
  removes pods explicitly, so no list rescan is needed).
- **Actual state of world**: which of those volumes this node has
  actually mounted.
- **Reconcile** (the reference's 100ms reconciler loop; here driven from
  the kubelet sync loop): claim-backed volumes wait for the attach/detach
  CONTROLLER to attach — ``node.status.volumesAttached`` is the handshake
  (``reconciler.go`` mountAttachVolumes → verify attached, matching
  ``kubelet.go`` WaitForAttachAndMount on the other side); node-local
  volumes (emptyDir, configMap projections, ephemeral scratch) mount
  immediately. Volumes whose last desired consumer is gone unmount.
- **volumesInUse** is published BY the reconciler, from the desired
  state (reference ``volume_manager.go`` GetVolumesInUse: "all volumes
  that implement the volume.Attacher interface ... in the desired state
  of world" — mounted or still mounting), so the attach/detach
  controller's safe-detach interlock covers an in-flight mount. Like the
  reference's markVolumesAsReportedInUse handshake, a claim-backed
  volume is mounted only after it appeared in a published report —
  never mount a volume detachable out from under the mount.

Container start gates on ``volumes_ready`` (the reference blocks the pod
worker in WaitForAttachAndMount, ``volume_manager.go:387``); unmount
happens at pod teardown AFTER the sandbox stopped, and detach only after
the resulting in-use shrink — the teardown ordering the reference
enforces between kubelet and the attachdetach controller.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Set

from kubernetes_tpu_torch.api.types import Pod

_logger = logging.getLogger(__name__)


class VolumeManager:
    def __init__(self, store, node_name: str):
        self.store = store
        self.node_name = node_name
        self._lock = threading.Lock()
        # DSW: pod uid -> {volume name: claim name or None (node-local)}
        self._dsw: Dict[str, Dict[str, Optional[str]]] = {}
        self._ns_of: Dict[str, str] = {}       # uid -> namespace
        # ASW: pod uid -> mounted volume names
        self._mounted: Dict[str, Set[str]] = {}
        # the last volumesInUse report that reached the API (the
        # reported-in-use handshake: mounts wait for it)
        self._reported_in_use: Set[str] = set()
        # (uid, volume name) -> PV name, pinned at first resolution:
        # the in-use report must keep covering a MOUNTED volume even if
        # its PVC object disappears mid-flight (namespace teardown, no
        # pvc-protection controller) — recomputing from the store would
        # shrink the report and let the attachdetach controller detach
        # under a running container
        self._pv_pin: Dict[tuple, str] = {}

    # -- desired state --------------------------------------------------
    def add_pod(self, pod: Pod) -> None:
        """Register the pod's volumes in the desired state (populator
        findAndAddNewPods). Idempotent."""
        with self._lock:
            self._dsw[pod.uid] = {
                v.name: (v.persistent_volume_claim or None)
                for v in pod.spec.volumes
            }
            self._ns_of[pod.uid] = pod.namespace

    def remove_pod(self, uid: str) -> None:
        """Drop the pod from the desired state (populator
        findAndRemoveDeletedPods); the next reconcile unmounts."""
        with self._lock:
            self._dsw.pop(uid, None)

    # -- queries --------------------------------------------------------
    def volumes_ready(self, pod: Pod) -> bool:
        """True when every volume the pod mounts is in the actual state
        (the WaitForAttachAndMount gate)."""
        with self._lock:
            mounted = self._mounted.get(pod.uid, set())
        return all(v.name in mounted for v in pod.spec.volumes)

    def mounted(self, uid: str) -> List[str]:
        with self._lock:
            return sorted(self._mounted.get(uid, ()))

    def pending_pods(self) -> List[str]:
        """Pods whose desired volumes are not all mounted yet."""
        with self._lock:
            return [
                uid for uid, vols in self._dsw.items()
                if set(vols) - self._mounted.get(uid, set())
            ]

    # -- reconcile ------------------------------------------------------
    def _pv_name(self, uid: str, vname: str, claim: str) -> Optional[str]:
        pin = self._pv_pin.get((uid, vname))
        if pin is not None:
            return pin
        pvc = self.store.get_pvc(self._ns_of.get(uid, "default"), claim)
        if pvc is not None and pvc.volume_name:
            self._pv_pin[(uid, vname)] = pvc.volume_name
            return pvc.volume_name
        return None

    def reconcile(self) -> List[str]:
        """One reconciler pass. Returns pod uids whose volumes became
        fully mounted in THIS pass (the kubelet re-syncs them so their
        containers start)."""
        with self._lock:
            dsw = {uid: dict(vols) for uid, vols in self._dsw.items()}
            mounted = {uid: set(vs) for uid, vs in self._mounted.items()}

        # 1. publish volumesInUse from the DESIRED state — before any
        #    mount, so the controller's detach interlock always covers
        #    the mount about to happen
        in_use: Set[str] = set()
        for uid, vols in dsw.items():
            for vname, claim in vols.items():
                if claim:
                    pv = self._pv_name(uid, vname, claim)
                    if pv:
                        in_use.add(pv)
        self._publish_in_use(in_use)

        # 2. mount pass: attach-requiring volumes need the controller's
        #    volumesAttached handshake AND a published in-use report
        node = self.store.get_node(self.node_name)
        attached = set(node.status.volumes_attached) if node else set()
        with self._lock:
            reported = set(self._reported_in_use)
        newly_ready: List[str] = []
        for uid, vols in dsw.items():
            have = mounted.get(uid, set())
            missing = set(vols) - have
            if not missing:
                continue
            for vname in sorted(missing):
                claim = vols[vname]
                if claim is None:
                    have.add(vname)          # node-local: mount directly
                    continue
                pv = self._pv_name(uid, vname, claim)
                if pv is not None and pv in attached and pv in reported:
                    have.add(vname)
            mounted[uid] = have
            if not set(vols) - have:
                newly_ready.append(uid)

        # 3. unmount pass: actual-state entries with no desired consumer
        for uid in list(mounted):
            if uid not in dsw:
                del mounted[uid]

        with self._lock:
            self._mounted = mounted
            for uid in list(self._ns_of):
                if uid not in self._dsw:
                    del self._ns_of[uid]
        for key in list(self._pv_pin):
            if key[0] not in dsw:
                del self._pv_pin[key]
        return newly_ready

    def _publish_in_use(self, in_use: Set[str]) -> None:
        report = sorted(in_use)

        def mutate(n) -> bool:
            if n.status.volumes_in_use == report:
                return False
            n.status.volumes_in_use = report
            return True

        try:
            self.store.mutate_object("Node", "", self.node_name, mutate)
        except Exception:  # noqa: BLE001 — node may not exist yet
            _logger.debug("volumesInUse report failed", exc_info=True)
            return
        with self._lock:
            self._reported_in_use = in_use
