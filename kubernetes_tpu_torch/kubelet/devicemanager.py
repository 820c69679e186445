"""Device manager: extended-resource allocation with checkpointing.

Behavioral equivalent of the reference's kubelet device-plugin manager
(``pkg/kubelet/cm/devicemanager/manager.go``): device plugins register a
resource name (here the canonical one is ``google.com/tpu`` rather than
``nvidia.com/gpu``) with a set of device IDs; the manager allocates
concrete IDs to containers at pod admission, reports
capacity/allocatable up to the node status, and checkpoints assignments
(``cm/devicemanager/checkpoint/checkpoint.go``) so a kubelet restart
doesn't double-allocate.

TPU-native twist: a plugin can expose a device *topology* (the chip's
position in the pod slice) so allocations prefer ICI-contiguous chips —
the analog of the reference's NUMA-aware TopologyManager hints
(``pkg/kubelet/cm/topologymanager``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from kubernetes_tpu_torch.kubelet.checkpoint import CheckpointManager

TPU_RESOURCE = "google.com/tpu"


@dataclass
class DevicePlugin:
    """A registered plugin: resource name + healthy device IDs, with an
    optional (x, y) mesh coordinate per device for topology-aware
    allocation."""

    resource: str
    device_ids: List[str]
    topology: Dict[str, Tuple[int, int]] = field(default_factory=dict)


class DeviceAllocationError(Exception):
    pass


class DeviceManager:
    CHECKPOINT = "device_manager_state"

    def __init__(self, checkpoints: Optional[CheckpointManager] = None):
        self._lock = threading.Lock()
        self._plugins: Dict[str, DevicePlugin] = {}
        # resource -> {device_id -> "pod_uid/container"}
        self._allocated: Dict[str, Dict[str, str]] = {}
        self._checkpoints = checkpoints
        if checkpoints is not None:
            state = checkpoints.get(self.CHECKPOINT)
            if state:
                self._allocated = {
                    res: dict(assign) for res, assign in state.items()
                }

    # -- plugin registration -------------------------------------------
    def register(self, plugin: DevicePlugin) -> None:
        with self._lock:
            self._plugins[plugin.resource] = plugin
            self._allocated.setdefault(plugin.resource, {})
            # drop assignments for devices the plugin no longer reports
            live = set(plugin.device_ids)
            self._allocated[plugin.resource] = {
                d: owner
                for d, owner in self._allocated[plugin.resource].items()
                if d in live
            }
            self._save()

    def capacity(self) -> Dict[str, int]:
        with self._lock:
            return {r: len(p.device_ids) for r, p in self._plugins.items()}

    def allocatable(self) -> Dict[str, int]:
        with self._lock:
            return {
                r: len(p.device_ids) - len(self._allocated.get(r, {}))
                for r, p in self._plugins.items()
            }

    # -- allocation ----------------------------------------------------
    def allocate(self, pod_uid: str, container: str, resource: str,
                 count: int) -> List[str]:
        """Pick count free devices (topology-contiguous when the plugin
        reports coordinates), record + checkpoint the assignment."""
        with self._lock:
            plugin = self._plugins.get(resource)
            if plugin is None:
                raise DeviceAllocationError(f"no device plugin for {resource!r}")
            taken = self._allocated.setdefault(resource, {})
            free = [d for d in plugin.device_ids if d not in taken]
            if len(free) < count:
                raise DeviceAllocationError(
                    f"{resource}: want {count}, have {len(free)} free"
                )
            chosen = self._pick_contiguous(free, plugin.topology, count)
            owner = f"{pod_uid}/{container}"
            for d in chosen:
                taken[d] = owner
            self._save()
            return chosen

    @staticmethod
    def _pick_contiguous(free: Sequence[str],
                         topo: Dict[str, Tuple[int, int]],
                         count: int) -> List[str]:
        if not topo:
            return list(free[:count])
        # greedy nearest-neighbor walk over mesh coordinates: start at the
        # lexicographically smallest free coordinate, then repeatedly take
        # the free device closest (L1) to the chosen set — keeps multi-chip
        # allocations ICI-adjacent without solving full rectangle packing
        coords = {d: topo.get(d, (1 << 30, 1 << 30)) for d in free}
        remaining = sorted(free, key=lambda d: coords[d])
        chosen = [remaining.pop(0)]
        while len(chosen) < count:
            cx = [coords[d] for d in chosen]

            def dist(d):
                x, y = coords[d]
                return min(abs(x - a) + abs(y - b) for a, b in cx)

            nxt = min(remaining, key=dist)
            remaining.remove(nxt)
            chosen.append(nxt)
        return chosen

    def free(self, pod_uid: str) -> None:
        """Release every device held by the pod (pod deletion path)."""
        with self._lock:
            prefix = f"{pod_uid}/"
            for assign in self._allocated.values():
                for d in [d for d, o in assign.items() if o.startswith(prefix)]:
                    del assign[d]
            self._save()

    def devices_of(self, pod_uid: str) -> Dict[str, List[str]]:
        with self._lock:
            prefix = f"{pod_uid}/"
            out: Dict[str, List[str]] = {}
            for res, assign in self._allocated.items():
                ids = [d for d, o in assign.items() if o.startswith(prefix)]
                if ids:
                    out[res] = sorted(ids)
            return out

    def _save(self) -> None:
        if self._checkpoints is not None:
            self._checkpoints.create(self.CHECKPOINT, self._allocated)
