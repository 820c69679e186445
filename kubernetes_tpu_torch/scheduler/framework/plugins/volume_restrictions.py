"""VolumeRestrictions filter (reference
``plugins/volumerestrictions/volume_restrictions.go``): exclusivity rules —
a GCE PD / AWS EBS volume may not be used read-write by two pods on the same
node; RBD/ISCSI images are node-exclusive."""

from typing import Optional

from kubernetes_tpu_torch.api.types import Pod, Volume
from kubernetes_tpu_torch.scheduler.framework.interface import (
    UNSCHEDULABLE_AND_UNRESOLVABLE,
    FilterPlugin,
    Status,
)
from kubernetes_tpu_torch.scheduler.types import NodeInfo

ERR_REASON_DISK_CONFLICT = "node(s) had no available disk"


def _volume_ids(vol: Volume):
    if vol.gce_persistent_disk:
        yield ("gce", vol.gce_persistent_disk)
    if vol.aws_elastic_block_store:
        yield ("aws", vol.aws_elastic_block_store)
    if vol.rbd:
        yield ("rbd", f"{vol.rbd.get('pool', 'rbd')}/{vol.rbd.get('image', '')}")
    if vol.iscsi:
        yield (
            "iscsi",
            f"{vol.iscsi.get('targetPortal', '')}/{vol.iscsi.get('iqn', '')}/"
            f"{vol.iscsi.get('lun', 0)}",
        )


class VolumeRestrictions(FilterPlugin):
    NAME = "VolumeRestrictions"

    @staticmethod
    def factory(args, handle):
        return VolumeRestrictions()

    def filter(self, state, pod: Pod, node_info: NodeInfo) -> Optional[Status]:
        wanted = {vid for v in pod.spec.volumes for vid in _volume_ids(v)}
        if not wanted:
            return None
        for pi in node_info.pods:
            for v in pi.pod.spec.volumes:
                for vid in _volume_ids(v):
                    if vid in wanted:
                        return Status(
                            UNSCHEDULABLE_AND_UNRESOLVABLE, ERR_REASON_DISK_CONFLICT
                        )
        return None
