"""VolumeZone filter (reference ``plugins/volumezone/volume_zone.go``): a
bound PV carrying zone/region labels constrains the pod to nodes in that
zone/region."""

from typing import Optional

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.scheduler.framework.interface import (
    UNSCHEDULABLE,
    UNSCHEDULABLE_AND_UNRESOLVABLE,
    FilterPlugin,
    Status,
)
from kubernetes_tpu_torch.scheduler.types import NodeInfo

ERR_REASON_CONFLICT = "node(s) had no available volume zone"

TOPOLOGY_LABELS = (
    "topology.kubernetes.io/zone",
    "topology.kubernetes.io/region",
    "failure-domain.beta.kubernetes.io/zone",
    "failure-domain.beta.kubernetes.io/region",
)


class VolumeZone(FilterPlugin):
    NAME = "VolumeZone"

    @staticmethod
    def factory(args, handle):
        return VolumeZone(handle)

    def __init__(self, handle=None):
        self.handle = handle

    def filter(self, state, pod: Pod, node_info: NodeInfo) -> Optional[Status]:
        if node_info.node is None:
            return Status(UNSCHEDULABLE_AND_UNRESOLVABLE, "node not found")
        client = self.handle.client
        node_labels = node_info.node.metadata.labels
        for vol in pod.spec.volumes:
            if not vol.persistent_volume_claim:
                continue
            pvc = client.get_pvc(pod.namespace, vol.persistent_volume_claim)
            if pvc is None or not pvc.volume_name:
                continue
            pv = client.get_pv(pvc.volume_name)
            if pv is None:
                continue
            for label in TOPOLOGY_LABELS:
                pv_value = pv.metadata.labels.get(label)
                if pv_value is None:
                    continue
                # multi-zone PVs use __ separators (volume helper zones set)
                allowed = set(pv_value.split("__"))
                if node_labels.get(label) not in allowed:
                    return Status(UNSCHEDULABLE, ERR_REASON_CONFLICT)
        return None
