"""NodePorts PreFilter+Filter (reference ``plugins/nodeports/node_ports.go``):
host-port conflicts against ``NodeInfo.used_ports``."""

from typing import List, Optional

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.scheduler.framework.interface import (
    UNSCHEDULABLE,
    FilterPlugin,
    PreFilterPlugin,
    Status,
)
from kubernetes_tpu_torch.scheduler.types import NodeInfo, pod_host_ports, ports_conflict

PRE_FILTER_STATE_KEY = "PreFilterNodePorts"
ERR_REASON = "node(s) didn't have free ports for the requested pod ports"


class NodePorts(PreFilterPlugin, FilterPlugin):
    NAME = "NodePorts"

    @staticmethod
    def factory(args, handle):
        return NodePorts()

    def pre_filter(self, state, pod: Pod) -> Optional[Status]:
        state.write(PRE_FILTER_STATE_KEY, pod_host_ports(pod))
        return None

    def filter(self, state, pod: Pod, node_info: NodeInfo) -> Optional[Status]:
        try:
            wanted: List = state.read(PRE_FILTER_STATE_KEY)
        except KeyError:
            wanted = pod_host_ports(pod)
        if ports_conflict(node_info.used_ports, wanted):
            return Status(UNSCHEDULABLE, ERR_REASON)
        return None
