"""NodeName filter (reference ``plugins/nodename/node_name.go``)."""

from typing import Optional

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.scheduler.framework.interface import (
    UNSCHEDULABLE_AND_UNRESOLVABLE,
    FilterPlugin,
    Status,
)
from kubernetes_tpu_torch.scheduler.types import NodeInfo

ERR_REASON = "node(s) didn't match the requested hostname"


class NodeName(FilterPlugin):
    NAME = "NodeName"

    @staticmethod
    def factory(args, handle):
        return NodeName()

    def filter(self, state, pod: Pod, node_info: NodeInfo) -> Optional[Status]:
        if node_info.node is None:
            return Status(UNSCHEDULABLE_AND_UNRESOLVABLE, "node not found")
        if pod.spec.node_name and pod.spec.node_name != node_info.node.name:
            return Status(UNSCHEDULABLE_AND_UNRESOLVABLE, ERR_REASON)
        return None
