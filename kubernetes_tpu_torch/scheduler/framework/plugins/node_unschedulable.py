"""NodeUnschedulable filter (reference
``plugins/nodeunschedulable/node_unschedulable.go``): respects
``.spec.unschedulable`` unless the pod tolerates the synthetic
unschedulable taint."""

from typing import Optional

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.scheduler.framework.interface import (
    UNSCHEDULABLE_AND_UNRESOLVABLE,
    FilterPlugin,
    Status,
)
from kubernetes_tpu_torch.scheduler.predicates import passes_unschedulable
from kubernetes_tpu_torch.scheduler.types import NodeInfo

ERR_REASON_UNSCHEDULABLE = "node(s) were unschedulable"
ERR_REASON_UNKNOWN_CONDITION = "node(s) had unknown conditions"


class NodeUnschedulable(FilterPlugin):
    NAME = "NodeUnschedulable"

    @staticmethod
    def factory(args, handle):
        return NodeUnschedulable()

    def filter(self, state, pod: Pod, node_info: NodeInfo) -> Optional[Status]:
        if node_info.node is None:
            return Status(UNSCHEDULABLE_AND_UNRESOLVABLE, ERR_REASON_UNKNOWN_CONDITION)
        if passes_unschedulable(pod, node_info.node):
            return None
        return Status(UNSCHEDULABLE_AND_UNRESOLVABLE, ERR_REASON_UNSCHEDULABLE)
