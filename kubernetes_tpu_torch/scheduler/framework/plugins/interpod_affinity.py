"""InterPodAffinity (reference ``plugins/interpodaffinity/`` — 754 LoC, one
of the "big five"):

- PreFilter (filtering.go:162-235) builds topology-pair → match-count maps
  over all nodes: (1) existing pods' *required anti-affinity* terms that
  match the incoming pod, (2) existing pods matched by the incoming pod's
  required affinity terms, (3) by its required anti-affinity terms.
- Filter (filtering.go:313-374) is then O(terms) map lookups per node.
- PreScore/Score (scoring.go:129-282) accumulate weighted preferred-term
  matches per topology pair, min-max normalized.
"""

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.types import Pod
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
from kubernetes_tpu_torch.scheduler.types import NodeInfo, PodInfo

PRE_FILTER_STATE_KEY = "PreFilterInterPodAffinity"
PRE_SCORE_STATE_KEY = "PreScoreInterPodAffinity"

ERR_EXISTING_ANTI_AFFINITY = (
    "node(s) didn't satisfy existing pods anti-affinity rules"
)
ERR_ANTI_AFFINITY = "node(s) didn't match pod anti-affinity rules"
ERR_AFFINITY = "node(s) didn't match pod affinity rules"

TopologyPair = Tuple[str, str]


class _PreFilterState:
    __slots__ = (
        "existing_anti_affinity_counts",
        "affinity_counts",
        "anti_affinity_counts",
        "pod_info",
    )

    def __init__(self):
        self.existing_anti_affinity_counts: Dict[TopologyPair, int] = defaultdict(int)
        self.affinity_counts: Dict[TopologyPair, int] = defaultdict(int)
        self.anti_affinity_counts: Dict[TopologyPair, int] = defaultdict(int)
        self.pod_info: Optional[PodInfo] = None

    def clone(self) -> "_PreFilterState":
        c = _PreFilterState()
        c.existing_anti_affinity_counts = defaultdict(
            int, self.existing_anti_affinity_counts
        )
        c.affinity_counts = defaultdict(int, self.affinity_counts)
        c.anti_affinity_counts = defaultdict(int, self.anti_affinity_counts)
        c.pod_info = self.pod_info
        return c

    def update_existing_anti_affinity(self, existing: PodInfo, node, sign: int) -> None:
        """Existing pod's required anti-affinity terms vs the incoming pod."""
        incoming = self.pod_info
        labels = node.metadata.labels
        for term in existing.required_anti_affinity_terms:
            if term.topology_key in labels and term.matches(incoming.pod):
                self.existing_anti_affinity_counts[
                    (term.topology_key, labels[term.topology_key])
                ] += sign

    def update(self, existing: PodInfo, node, sign: int) -> None:
        """Apply one existing pod's full contribution (reference
        updateWithPod; used by the AddPod/RemovePod extensions)."""
        incoming = self.pod_info
        labels = node.metadata.labels
        self.update_existing_anti_affinity(existing, node, sign)
        # incoming's terms vs existing pod
        for term in incoming.required_affinity_terms:
            if term.topology_key in labels and term.matches(existing.pod):
                self.affinity_counts[
                    (term.topology_key, labels[term.topology_key])
                ] += sign
        for term in incoming.required_anti_affinity_terms:
            if term.topology_key in labels and term.matches(existing.pod):
                self.anti_affinity_counts[
                    (term.topology_key, labels[term.topology_key])
                ] += sign


class InterPodAffinity(
    PreFilterPlugin, FilterPlugin, PreScorePlugin, ScorePlugin
):
    NAME = "InterPodAffinity"

    @staticmethod
    def factory(args, handle):
        return InterPodAffinity(handle, args or {})

    def __init__(self, handle=None, args=None):
        self.handle = handle
        self.hard_pod_affinity_weight = int(
            (args or {}).get("hardPodAffinityWeight", 1)
        )

    # ------------------------------------------------------------------
    def pre_filter(self, state, pod: Pod) -> Optional[Status]:
        snapshot = self.handle.snapshot()
        s = _PreFilterState()
        s.pod_info = PodInfo(pod)
        # pass 1: existing required anti-affinity (affinity-specialized list)
        for ni in snapshot.have_pods_with_required_anti_affinity_list():
            if ni.node is None:
                continue
            for existing in ni.pods_with_required_anti_affinity:
                s.update_existing_anti_affinity(existing, ni.node, +1)
        # pass 2: incoming's required terms vs every pod (all nodes)
        if s.pod_info.required_affinity_terms or s.pod_info.required_anti_affinity_terms:
            for ni in snapshot.list():
                if ni.node is None:
                    continue
                labels = ni.node.metadata.labels
                for existing in ni.pods:
                    incoming = s.pod_info
                    for term in incoming.required_affinity_terms:
                        if term.topology_key in labels and term.matches(existing.pod):
                            s.affinity_counts[
                                (term.topology_key, labels[term.topology_key])
                            ] += 1
                    for term in incoming.required_anti_affinity_terms:
                        if term.topology_key in labels and term.matches(existing.pod):
                            s.anti_affinity_counts[
                                (term.topology_key, labels[term.topology_key])
                            ] += 1
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
            return Status(1, "reading InterPodAffinity prefilter state")
        labels = node_info.node.metadata.labels

        # 1. existing pods' anti-affinity must not fire on this node
        for (key, value), count in s.existing_anti_affinity_counts.items():
            if count > 0 and labels.get(key) == value:
                return Status(UNSCHEDULABLE, ERR_EXISTING_ANTI_AFFINITY)

        # 2. incoming pod's anti-affinity
        for term in s.pod_info.required_anti_affinity_terms:
            value = labels.get(term.topology_key)
            if value is not None and s.anti_affinity_counts.get(
                (term.topology_key, value), 0
            ) > 0:
                return Status(UNSCHEDULABLE, ERR_ANTI_AFFINITY)

        # 3. incoming pod's affinity: every term must be satisfied here
        if s.pod_info.required_affinity_terms:
            satisfied = all(
                term.topology_key in labels
                and s.affinity_counts.get(
                    (term.topology_key, labels[term.topology_key]), 0
                )
                > 0
                for term in s.pod_info.required_affinity_terms
            )
            if not satisfied:
                # special case (filtering.go): allow the FIRST pod of a
                # self-selecting group to land anywhere
                matches_self = all(
                    term.matches(pod) for term in s.pod_info.required_affinity_terms
                )
                no_matches_anywhere = all(
                    c == 0 for c in s.affinity_counts.values()
                )
                if not (matches_self and no_matches_anywhere):
                    return Status(UNSCHEDULABLE, ERR_AFFINITY)
        return None

    # ------------------------------------------------------------------
    def pre_score(self, state, pod: Pod, nodes: List) -> Optional[Status]:
        incoming = PodInfo(pod)
        has_preferred = bool(
            incoming.preferred_affinity_terms or incoming.preferred_anti_affinity_terms
        )
        score_map: Dict[TopologyPair, float] = defaultdict(float)
        snapshot = self.handle.snapshot()
        # choose the smaller iteration set when the incoming pod has no
        # preferred terms (only existing pods' terms can contribute)
        node_infos = snapshot.list() if has_preferred else snapshot.have_pods_with_affinity_list()
        for ni in node_infos:
            if ni.node is None:
                continue
            labels = ni.node.metadata.labels
            existing_list = ni.pods if has_preferred else ni.pods_with_affinity
            for existing in existing_list:
                self._process_existing(incoming, existing, labels, score_map)
        state.write(PRE_SCORE_STATE_KEY, score_map)
        return None

    def _process_existing(self, incoming: PodInfo, existing: PodInfo, labels,
                          score_map) -> None:
        for wt in incoming.preferred_affinity_terms:
            if wt.term.topology_key in labels and wt.term.matches(existing.pod):
                score_map[(wt.term.topology_key, labels[wt.term.topology_key])] += wt.weight
        for wt in incoming.preferred_anti_affinity_terms:
            if wt.term.topology_key in labels and wt.term.matches(existing.pod):
                score_map[(wt.term.topology_key, labels[wt.term.topology_key])] -= wt.weight
        if self.hard_pod_affinity_weight > 0:
            for term in existing.required_affinity_terms:
                if term.topology_key in labels and term.matches(incoming.pod):
                    score_map[(term.topology_key, labels[term.topology_key])] += (
                        self.hard_pod_affinity_weight
                    )
        for wt in existing.preferred_affinity_terms:
            if wt.term.topology_key in labels and wt.term.matches(incoming.pod):
                score_map[(wt.term.topology_key, labels[wt.term.topology_key])] += wt.weight
        for wt in existing.preferred_anti_affinity_terms:
            if wt.term.topology_key in labels and wt.term.matches(incoming.pod):
                score_map[(wt.term.topology_key, labels[wt.term.topology_key])] -= wt.weight

    def score(self, state, pod: Pod, node_name: str) -> Tuple[int, Optional[Status]]:
        node_info = self.handle.snapshot().get(node_name)
        if node_info is None or node_info.node is None:
            return 0, Status(1, f"node {node_name} not found")
        try:
            score_map = state.read(PRE_SCORE_STATE_KEY)
        except KeyError:
            return 0, None
        labels = node_info.node.metadata.labels
        total = 0.0
        for (key, value), val in score_map.items():
            if labels.get(key) == value:
                total += val
        return int(total), None

    def score_extensions(self):
        return _Normalize()


class _Normalize(ScoreExtensions):
    def normalize_score(self, state, pod, scores: List[NodeScore]):
        if not scores:
            return None
        max_s = max(s.score for s in scores)
        min_s = min(s.score for s in scores)
        spread = max_s - min_s
        for s in scores:
            if spread == 0:
                s.score = 0 if max_s == 0 else MAX_NODE_SCORE
            else:
                s.score = int(MAX_NODE_SCORE * (s.score - min_s) / spread)
        return None


class _Extensions(PreFilterExtensions):
    """Incremental updates for nominated pods / preemption victims
    (filtering.go AddPod/RemovePod)."""

    def add_pod(self, state, pod_to_schedule, pod_to_add, node_info):
        s: _PreFilterState = state.read(PRE_FILTER_STATE_KEY)
        if node_info.node is not None:
            s.update(PodInfo(pod_to_add), node_info.node, +1)
        return None

    def remove_pod(self, state, pod_to_schedule, pod_to_remove, node_info):
        s: _PreFilterState = state.read(PRE_FILTER_STATE_KEY)
        if node_info.node is not None:
            s.update(PodInfo(pod_to_remove), node_info.node, -1)
        return None
