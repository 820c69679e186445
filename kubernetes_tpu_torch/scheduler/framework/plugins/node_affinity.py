"""NodeAffinity filter+score (reference
``plugins/nodeaffinity/node_affinity.go``): required terms filter, preferred
terms score (weights summed, min-max normalized)."""

from typing import List, Optional, Tuple

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.scheduler.framework.interface import (
    MAX_NODE_SCORE,
    UNSCHEDULABLE,
    UNSCHEDULABLE_AND_UNRESOLVABLE,
    FilterPlugin,
    NodeScore,
    ScoreExtensions,
    ScorePlugin,
    Status,
)
from kubernetes_tpu_torch.scheduler.framework.plugins.helpers import (
    default_normalize_score,
    node_selector_term_matches,
    pod_matches_node_selector_and_affinity,
)
from kubernetes_tpu_torch.scheduler.types import NodeInfo

ERR_REASON = "node(s) didn't match node selector"


class NodeAffinity(FilterPlugin, ScorePlugin):
    NAME = "NodeAffinity"

    @staticmethod
    def factory(args, handle):
        return NodeAffinity(handle)

    def __init__(self, handle=None):
        self.handle = handle

    def filter(self, state, pod: Pod, node_info: NodeInfo) -> Optional[Status]:
        if node_info.node is None:
            return Status(UNSCHEDULABLE_AND_UNRESOLVABLE, "node not found")
        if not pod_matches_node_selector_and_affinity(pod, node_info.node):
            return Status(UNSCHEDULABLE, ERR_REASON)
        return None

    def score(self, state, pod: Pod, node_name: str) -> Tuple[int, Optional[Status]]:
        node_info = self.handle.snapshot().get(node_name)
        if node_info is None or node_info.node is None:
            return 0, Status(1, f"node {node_name} not found")
        node = node_info.node
        count = 0
        aff = pod.spec.affinity
        if aff is not None and aff.node_affinity is not None:
            for term in aff.node_affinity.preferred_during_scheduling_ignored_during_execution:
                if term.weight and node_selector_term_matches(term.preference, node):
                    count += term.weight
        return count, None

    def score_extensions(self):
        return _Normalize()


class _Normalize(ScoreExtensions):
    def normalize_score(self, state, pod, scores: List[NodeScore]):
        default_normalize_score(MAX_NODE_SCORE, False, scores)
        return None
