"""TaintToleration filter + PreferNoSchedule scoring (reference
``plugins/tainttoleration/taint_toleration.go``)."""

from typing import List, Optional, Tuple

from kubernetes_tpu_torch.api.types import PREFER_NO_SCHEDULE, Pod
from kubernetes_tpu_torch.scheduler.framework.interface import (
    MAX_NODE_SCORE,
    UNSCHEDULABLE_AND_UNRESOLVABLE,
    FilterPlugin,
    NodeScore,
    PreScorePlugin,
    ScoreExtensions,
    ScorePlugin,
    Status,
)
from kubernetes_tpu_torch.scheduler.framework.plugins.helpers import default_normalize_score
from kubernetes_tpu_torch.scheduler.predicates import (
    find_untolerated_taint,
    is_hard_taint,
)
from kubernetes_tpu_torch.scheduler.types import NodeInfo

PRE_SCORE_STATE_KEY = "PreScoreTaintToleration"


class TaintToleration(FilterPlugin, PreScorePlugin, ScorePlugin):
    NAME = "TaintToleration"

    @staticmethod
    def factory(args, handle):
        return TaintToleration(handle)

    def __init__(self, handle=None):
        self.handle = handle

    def filter(self, state, pod: Pod, node_info: NodeInfo) -> Optional[Status]:
        if node_info.node is None:
            return Status(UNSCHEDULABLE_AND_UNRESOLVABLE, "node not found")
        taint = find_untolerated_taint(
            node_info.node.spec.taints,
            pod.spec.tolerations,
            is_hard_taint,
        )
        if taint is not None:
            return Status(
                UNSCHEDULABLE_AND_UNRESOLVABLE,
                f"node(s) had taint {{{taint.key}: {taint.value}}}, "
                "that the pod didn't tolerate",
            )
        return None

    def pre_score(self, state, pod: Pod, nodes: List) -> Optional[Status]:
        # only PreferNoSchedule-effect tolerations matter for scoring
        tolerations = [
            t
            for t in pod.spec.tolerations
            if t.effect in ("", PREFER_NO_SCHEDULE)
        ]
        state.write(PRE_SCORE_STATE_KEY, tolerations)
        return None

    def score(self, state, pod: Pod, node_name: str) -> Tuple[int, Optional[Status]]:
        node_info = self.handle.snapshot().get(node_name)
        if node_info is None or node_info.node is None:
            return 0, Status(1, f"node {node_name} not found")
        try:
            tolerations = state.read(PRE_SCORE_STATE_KEY)
        except KeyError:
            tolerations = []
        count = 0
        for taint in node_info.node.spec.taints:
            if taint.effect != PREFER_NO_SCHEDULE:
                continue
            if not any(t.tolerates(taint) for t in tolerations):
                count += 1
        return count, None

    def score_extensions(self):
        return _Normalize()


class _Normalize(ScoreExtensions):
    def normalize_score(self, state, pod, scores: List[NodeScore]):
        # more intolerable PreferNoSchedule taints -> lower score
        default_normalize_score(MAX_NODE_SCORE, True, scores)
        return None
