"""NodeLabel, Filter and Score (a legacy plugin, reached only through a
Policy's ``CheckNodeLabelPresence``; upstream
``plugins/nodelabel/node_label.go``): a node must carry every label of
``presentLabels`` and none of ``absentLabels``; it scores 100 for each
label of ``presentLabelsPreference`` it carries and each of
``absentLabelsPreference`` it lacks, averaged over the preferences."""

from typing import Optional, Tuple

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.scheduler.framework.interface import (
    MAX_NODE_SCORE,
    UNSCHEDULABLE,
    UNSCHEDULABLE_AND_UNRESOLVABLE,
    FilterPlugin,
    ScorePlugin,
    Status,
)
from kubernetes_tpu_torch.scheduler.types import NodeInfo

ERR_REASON_PRESENCE_VIOLATED = "node(s) didn't have the requested labels"


class NodeLabel(FilterPlugin, ScorePlugin):
    NAME = "NodeLabel"

    @staticmethod
    def factory(args, handle):
        return NodeLabel(handle, args or {})

    def __init__(self, handle=None, args=None):
        args = args or {}
        self.handle = handle
        self.present_labels = list(args.get("presentLabels") or [])
        self.absent_labels = list(args.get("absentLabels") or [])
        self.present_labels_preference = list(
            args.get("presentLabelsPreference") or []
        )
        self.absent_labels_preference = list(args.get("absentLabelsPreference") or [])

    def filter(self, state, pod: Pod, node_info: NodeInfo) -> Optional[Status]:
        if node_info.node is None:
            return Status(UNSCHEDULABLE_AND_UNRESOLVABLE, "node not found")
        labels = node_info.node.metadata.labels
        ok = all(l in labels for l in self.present_labels) and all(
            l not in labels for l in self.absent_labels
        )
        if not ok:
            return Status(UNSCHEDULABLE, ERR_REASON_PRESENCE_VIOLATED)
        return None

    def score(self, state, pod: Pod, node_name: str) -> Tuple[int, Optional[Status]]:
        node_info = self.handle.snapshot().get(node_name)
        if node_info is None or node_info.node is None:
            return 0, Status(1, f"node {node_name} not found")
        labels = node_info.node.metadata.labels
        score = 0
        total = len(self.present_labels_preference) + len(self.absent_labels_preference)
        if total == 0:
            return 0, None
        for l in self.present_labels_preference:
            if l in labels:
                score += MAX_NODE_SCORE
        for l in self.absent_labels_preference:
            if l not in labels:
                score += MAX_NODE_SCORE
        return score // total, None
