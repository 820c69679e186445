"""Node volume-count limits (reference ``plugins/nodevolumelimits/`` — 907
LoC across csi.go + non_csi.go): per-node attachable-volume caps for CSI
drivers (from CSINode allocatable) and the in-tree cloud disks.

Limit resolution order mirrors the reference:

- **CSI** (``csi.go``): the per-driver attach limit comes from the
  node's CSINode object (``drivers[].allocatable.count``). Bound PVCs
  resolve their driver through the PV (including in-tree PVs served via
  CSI migration — the PV carries the CSI driver name); UNBOUND PVCs
  resolve through the StorageClass provisioner
  (``getCSIDriverInfoFromSC``) — a pending claim still consumes an
  attach slot on whatever node it lands on, so it must count.
- **In-tree disks** (``non_csi.go``): per-node limit from the node's
  ``attachable-volumes-<kind>`` allocatable resource when the cloud
  provider published one, else the ``KUBE_MAX_PD_VOLS`` env override,
  else the fleet default (EBS 39, GCE PD 16, Azure Disk 16).
"""

import os
from typing import Optional, Set, Tuple

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.scheduler.framework.interface import (
    UNSCHEDULABLE,
    UNSCHEDULABLE_AND_UNRESOLVABLE,
    FilterPlugin,
    Status,
)
from kubernetes_tpu_torch.scheduler.types import NodeInfo

ERR_REASON = "node(s) exceed max volume count"

DEFAULT_EBS_LIMIT = 39
DEFAULT_GCE_PD_LIMIT = 16
DEFAULT_AZURE_LIMIT = 16


def pod_csi_volumes(client, pod: Pod) -> Set[Tuple[str, str]]:
    """(driver, volume-key) pairs the pod would attach. Bound PVCs
    resolve via the PV (csi.go getCSIDriverInfo); unbound PVCs via
    the StorageClass provisioner (getCSIDriverInfoFromSC) — keyed by
    the claim itself, since no PV exists yet. Shared single source of
    truth between this filter and the batch encoder's attach-limit
    resource columns (``ops/encode.py``) — the two must count the same
    volumes or the device path diverges from the host filter."""
    out = set()
    for vol in pod.spec.volumes:
        if not vol.persistent_volume_claim:
            continue
        pvc = client.get_pvc(pod.namespace, vol.persistent_volume_claim)
        if pvc is None:
            continue
        if pvc.volume_name:
            pv = client.get_pv(pvc.volume_name)
            if pv is None:
                continue
            driver = getattr(pv, "csi_driver", None)
            if driver:
                out.add((driver, pv.name))
            continue
        # unbound claim: the provisioner that WILL serve it defines
        # which driver's attach budget it consumes
        sc_name = pvc.storage_class_name
        if not sc_name:
            continue
        sc = client.get_storage_class(sc_name)
        if sc is None or not sc.provisioner:
            continue
        out.add((sc.provisioner, f"{pod.namespace}/{pvc.name}"))
    return out


class CSILimits(FilterPlugin):
    NAME = "NodeVolumeLimits"

    @staticmethod
    def factory(args, handle):
        return CSILimits(handle)

    def __init__(self, handle=None):
        self.handle = handle

    def filter(self, state, pod: Pod, node_info: NodeInfo) -> Optional[Status]:
        if node_info.node is None:
            return Status(UNSCHEDULABLE_AND_UNRESOLVABLE, "node not found")
        client = self.handle.client
        csi_node = client.get_csi_node(node_info.node.name)
        if csi_node is None:
            return None
        wanted = self._pod_csi_volumes(client, pod)
        if not wanted:
            return None
        in_use = set()
        for pi in node_info.pods:
            in_use |= self._pod_csi_volumes(client, pi.pod)
        for driver in csi_node.drivers:
            limit = driver.allocatable_count
            if limit is None:
                continue
            new_count = len(
                {v for d, v in (in_use | wanted) if d == driver.name}
            )
            if new_count > limit:
                return Status(UNSCHEDULABLE, ERR_REASON)
        return None

    def _pod_csi_volumes(self, client, pod: Pod) -> Set[Tuple[str, str]]:
        return pod_csi_volumes(client, pod)


class _InTreeLimits(FilterPlugin):
    """Shared logic for the in-tree cloud-disk limit filters
    (non_csi.go): limit = node allocatable attachable-volumes resource,
    else KUBE_MAX_PD_VOLS, else the per-cloud default."""

    volume_attr = ""
    # reference volumeutil.<kind>VolumeLimitKey, published by the cloud
    # provider in node.status.allocatable
    allocatable_key = ""
    default_limit = 0

    def __init__(self, handle=None):
        self.handle = handle

    def _node_limit(self, node_info: NodeInfo) -> int:
        node = node_info.node
        if node is not None:
            qty = node.status.allocatable.get(self.allocatable_key)
            if qty is not None:
                return int(qty.value())
        env = os.environ.get("KUBE_MAX_PD_VOLS")
        if env:
            try:
                return int(env)
            except ValueError:
                pass
        return self.default_limit

    def filter(self, state, pod: Pod, node_info: NodeInfo) -> Optional[Status]:
        wanted = {
            getattr(v, self.volume_attr)
            for v in pod.spec.volumes
            if getattr(v, self.volume_attr)
        }
        if not wanted:
            return None
        in_use = {
            getattr(v, self.volume_attr)
            for pi in node_info.pods
            for v in pi.pod.spec.volumes
            if getattr(v, self.volume_attr)
        }
        if len(in_use | wanted) > self._node_limit(node_info):
            return Status(UNSCHEDULABLE, ERR_REASON)
        return None


class EBSLimits(_InTreeLimits):
    NAME = "EBSLimits"
    volume_attr = "aws_elastic_block_store"
    allocatable_key = "attachable-volumes-aws-ebs"
    default_limit = DEFAULT_EBS_LIMIT

    @staticmethod
    def factory(args, handle):
        return EBSLimits(handle)


class GCEPDLimits(_InTreeLimits):
    NAME = "GCEPDLimits"
    volume_attr = "gce_persistent_disk"
    allocatable_key = "attachable-volumes-gce-pd"
    default_limit = DEFAULT_GCE_PD_LIMIT

    @staticmethod
    def factory(args, handle):
        return GCEPDLimits(handle)


class AzureDiskLimits(_InTreeLimits):
    NAME = "AzureDiskLimits"
    volume_attr = "azure_disk"
    allocatable_key = "attachable-volumes-azure-disk"
    default_limit = DEFAULT_AZURE_LIMIT

    @staticmethod
    def factory(args, handle):
        return AzureDiskLimits(handle)
