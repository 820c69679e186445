"""PodTopologySpread (reference ``plugins/podtopologyspread/`` — 843 LoC,
one of the "big five"):

- PreFilter (filtering.go:198-273) counts matching pods per topology pair
  for each DoNotSchedule constraint, over nodes that pass the incoming
  pod's node affinity/selector, and tracks the per-key minimum.
- Filter (filtering.go:313-324): ``matchNum + selfMatch − minMatchNum ≤ maxSkew``.
- Score (scoring.go:109-253) for ScheduleAnyway constraints: fewer matching
  pods in the node's topology domain → higher score.
"""

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.labels import selector_from_label_selector
from kubernetes_tpu_torch.api.types import Pod, TopologySpreadConstraint
from kubernetes_tpu_torch.scheduler.framework.interface import (
    MAX_NODE_SCORE,
    UNSCHEDULABLE,
    UNSCHEDULABLE_AND_UNRESOLVABLE,
    FilterPlugin,
    NodeScore,
    PreFilterExtensions,
    PreFilterPlugin,
    PreScorePlugin,
    ScoreExtensions,
    ScorePlugin,
    Status,
)
from kubernetes_tpu_torch.scheduler.framework.plugins.helpers import (
    pod_matches_node_selector_and_affinity,
)
from kubernetes_tpu_torch.scheduler.types import NodeInfo

PRE_FILTER_STATE_KEY = "PreFilterPodTopologySpread"
PRE_SCORE_STATE_KEY = "PreScorePodTopologySpread"

ERR_REASON = "node(s) didn't match pod topology spread constraints"
ERR_REASON_MISSING_LABEL = ERR_REASON + " (missing required label)"

DO_NOT_SCHEDULE = "DoNotSchedule"
SCHEDULE_ANYWAY = "ScheduleAnyway"

TopologyPair = Tuple[str, str]


class _Constraint:
    __slots__ = ("max_skew", "topology_key", "selector")

    def __init__(self, c: TopologySpreadConstraint):
        self.max_skew = c.max_skew
        self.topology_key = c.topology_key
        self.selector = selector_from_label_selector(c.label_selector)

    def matches(self, pod: Pod, namespace: str) -> bool:
        return pod.namespace == namespace and self.selector.matches(
            pod.metadata.labels
        )


class _PreFilterState:
    __slots__ = ("constraints", "tp_counts", "tp_key_domains", "namespace")

    def __init__(self):
        self.constraints: List[_Constraint] = []
        self.tp_counts: Dict[TopologyPair, int] = defaultdict(int)
        # per topology key: the set of values seen on eligible nodes
        # (needed to compute the min even when a domain has zero matches)
        self.tp_key_domains: Dict[str, set] = defaultdict(set)
        self.namespace = ""

    def clone(self) -> "_PreFilterState":
        c = _PreFilterState()
        c.constraints = self.constraints
        c.tp_counts = defaultdict(int, self.tp_counts)
        c.tp_key_domains = defaultdict(set, {
            k: set(v) for k, v in self.tp_key_domains.items()
        })
        c.namespace = self.namespace
        return c

    def min_match(self, key: str) -> int:
        domains = self.tp_key_domains.get(key)
        if not domains:
            return 0
        return min(self.tp_counts.get((key, v), 0) for v in domains)

    def update(self, pod: Pod, node, sign: int) -> None:
        labels = node.metadata.labels
        for c in self.constraints:
            if c.topology_key not in labels:
                continue
            if c.matches(pod, self.namespace):
                self.tp_counts[(c.topology_key, labels[c.topology_key])] += sign


def _pod_constraints(pod: Pod, action: str) -> List[_Constraint]:
    return [
        _Constraint(c)
        for c in pod.spec.topology_spread_constraints
        if c.when_unsatisfiable == action and c.topology_key
    ]


class PodTopologySpread(
    PreFilterPlugin, FilterPlugin, PreScorePlugin, ScorePlugin
):
    NAME = "PodTopologySpread"

    @staticmethod
    def factory(args, handle):
        return PodTopologySpread(handle, args or {})

    def __init__(self, handle=None, args=None):
        self.handle = handle
        args = args or {}
        self.default_constraints = [
            TopologySpreadConstraint.from_dict(c)
            for c in (args.get("defaultConstraints") or [])
        ]

    # ------------------------------------------------------------------
    def pre_filter(self, state, pod: Pod) -> Optional[Status]:
        s = _PreFilterState()
        s.namespace = pod.namespace
        s.constraints = _pod_constraints(pod, DO_NOT_SCHEDULE)
        if not s.constraints and self.default_constraints:
            s.constraints = [
                _Constraint(c)
                for c in self.default_constraints
                if c.when_unsatisfiable == DO_NOT_SCHEDULE
            ]
        if s.constraints:
            for ni in self.handle.snapshot().list():
                node = ni.node
                if node is None:
                    continue
                # only nodes the incoming pod could land on count toward
                # skew (filtering.go: nodeAffinity pre-check)
                if not pod_matches_node_selector_and_affinity(pod, node):
                    continue
                labels = node.metadata.labels
                for c in s.constraints:
                    if c.topology_key not in labels:
                        continue
                    value = labels[c.topology_key]
                    s.tp_key_domains[c.topology_key].add(value)
                    count = sum(
                        1
                        for pi in ni.pods
                        if pi.pod.metadata.deletion_timestamp is None
                        and c.matches(pi.pod, s.namespace)
                    )
                    if count:
                        s.tp_counts[(c.topology_key, value)] += count
        state.write(PRE_FILTER_STATE_KEY, s)
        return None

    def pre_filter_extensions(self):
        return _Extensions()

    def filter(self, state, pod: Pod, node_info: NodeInfo) -> Optional[Status]:
        if node_info.node is None:
            return Status(UNSCHEDULABLE_AND_UNRESOLVABLE, "node not found")
        try:
            s: _PreFilterState = state.read(PRE_FILTER_STATE_KEY)
        except KeyError:
            return Status(1, "reading PodTopologySpread prefilter state")
        if not s.constraints:
            return None
        labels = node_info.node.metadata.labels
        for c in s.constraints:
            if c.topology_key not in labels:
                return Status(
                    UNSCHEDULABLE_AND_UNRESOLVABLE, ERR_REASON_MISSING_LABEL
                )
            value = labels[c.topology_key]
            self_match = 1 if c.selector.matches(pod.metadata.labels) else 0
            match_num = s.tp_counts.get((c.topology_key, value), 0)
            skew = match_num + self_match - s.min_match(c.topology_key)
            if skew > c.max_skew:
                return Status(UNSCHEDULABLE, ERR_REASON)
        return None

    # ------------------------------------------------------------------
    def pre_score(self, state, pod: Pod, nodes: List) -> Optional[Status]:
        constraints = _pod_constraints(pod, SCHEDULE_ANYWAY)
        if not constraints and self.default_constraints:
            constraints = [
                _Constraint(c)
                for c in self.default_constraints
                if c.when_unsatisfiable == SCHEDULE_ANYWAY
            ]
        counts: Dict[TopologyPair, int] = defaultdict(int)
        ignored_nodes = set()
        if constraints:
            for ni in self.handle.snapshot().list():
                node = ni.node
                if node is None:
                    continue
                labels = node.metadata.labels
                if any(c.topology_key not in labels for c in constraints):
                    ignored_nodes.add(node.name)
                    continue
                for c in constraints:
                    value = labels[c.topology_key]
                    count = sum(
                        1
                        for pi in ni.pods
                        if pi.pod.metadata.deletion_timestamp is None
                        and c.matches(pi.pod, pod.namespace)
                    )
                    counts[(c.topology_key, value)] += count
        state.write(
            PRE_SCORE_STATE_KEY, (constraints, counts, ignored_nodes)
        )
        return None

    def score(self, state, pod: Pod, node_name: str) -> Tuple[int, Optional[Status]]:
        node_info = self.handle.snapshot().get(node_name)
        if node_info is None or node_info.node is None:
            return 0, Status(1, f"node {node_name} not found")
        try:
            constraints, counts, ignored = state.read(PRE_SCORE_STATE_KEY)
        except KeyError:
            return 0, None
        if not constraints or node_name in ignored:
            return 0, None
        labels = node_info.node.metadata.labels
        total = 0
        for c in constraints:
            value = labels.get(c.topology_key)
            if value is not None:
                total += counts.get((c.topology_key, value), 0)
        return total, None

    def score_extensions(self):
        return _Normalize()


class _Normalize(ScoreExtensions):
    def normalize_score(self, state, pod, scores: List[NodeScore]):
        """Fewer matching pods in the domain → higher score (inverted
        min-max, scoring.go NormalizeScore)."""
        try:
            constraints, _, ignored = state.read(PRE_SCORE_STATE_KEY)
        except KeyError:
            return None
        if not constraints:
            return None
        relevant = [s for s in scores if s.name not in ignored]
        if not relevant:
            return None
        max_s = max(s.score for s in relevant)
        min_s = min(s.score for s in relevant)
        spread = max_s - min_s
        for s in scores:
            if s.name in ignored:
                s.score = 0
                continue
            if spread == 0:
                s.score = MAX_NODE_SCORE
            else:
                s.score = int(MAX_NODE_SCORE * (max_s - s.score) / spread)
        return None


class _Extensions(PreFilterExtensions):
    def add_pod(self, state, pod_to_schedule, pod_to_add, node_info):
        s: _PreFilterState = state.read(PRE_FILTER_STATE_KEY)
        if node_info.node is not None and pod_matches_node_selector_and_affinity(
            pod_to_schedule, node_info.node
        ):
            s.update(pod_to_add, node_info.node, +1)
        return None

    def remove_pod(self, state, pod_to_schedule, pod_to_remove, node_info):
        s: _PreFilterState = state.read(PRE_FILTER_STATE_KEY)
        if node_info.node is not None and pod_matches_node_selector_and_affinity(
            pod_to_schedule, node_info.node
        ):
            s.update(pod_to_remove, node_info.node, -1)
        return None
