"""SelectorSpread score (legacy default spreading; reference
``plugins/selectorspread/selector_spread.go``): spreads pods belonging to
the same Service/ReplicationController/ReplicaSet/StatefulSet across nodes
and zones (zone weighted 2/3)."""

from typing import List, Optional, Tuple

from kubernetes_tpu_torch.api.labels import Selector
from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.scheduler.framework.interface import (
    MAX_NODE_SCORE,
    NodeScore,
    PreScorePlugin,
    ScoreExtensions,
    ScorePlugin,
    Status,
)
from kubernetes_tpu_torch.scheduler.snapshot import get_zone_key

PRE_SCORE_STATE_KEY = "PreScoreSelectorSpread"
ZONE_WEIGHTING = 2.0 / 3.0


def get_pod_selectors(client, pod: Pod) -> List[Selector]:
    """Selectors of every controller-ish object selecting this pod
    (reference helper.DefaultSelector): the pod's namespace's Services,
    ReplicationControllers, ReplicaSets and StatefulSets whose selector
    matches its labels."""
    selectors: List[Selector] = []
    ns = pod.namespace
    labels = pod.metadata.labels
    for svc in client.list_services(ns):
        sel = Selector.from_map(svc.selector)
        if not sel.is_empty() and sel.matches(labels):
            selectors.append(sel)
    for rc in client.list_replication_controllers(ns):
        sel = Selector.from_map(rc.selector)
        if not sel.is_empty() and sel.matches(labels):
            selectors.append(sel)
    for rs in client.list_replica_sets(ns):
        if rs.selector is not None:
            sel = rs.selector.to_selector()
            if sel.matches(labels):
                selectors.append(sel)
    for ss in client.list_stateful_sets(ns):
        if ss.selector is not None:
            sel = ss.selector.to_selector()
            if sel.matches(labels):
                selectors.append(sel)
    return selectors


class SelectorSpread(PreScorePlugin, ScorePlugin):
    NAME = "SelectorSpread"

    @staticmethod
    def factory(args, handle):
        return SelectorSpread(handle)

    def __init__(self, handle=None):
        self.handle = handle

    def pre_score(self, state, pod: Pod, nodes: List) -> Optional[Status]:
        selectors = get_pod_selectors(self.handle.client, pod)
        state.write(PRE_SCORE_STATE_KEY, selectors)
        return None

    def score(self, state, pod: Pod, node_name: str) -> Tuple[int, Optional[Status]]:
        node_info = self.handle.snapshot().get(node_name)
        if node_info is None or node_info.node is None:
            return 0, Status(1, f"node {node_name} not found")
        try:
            selectors = state.read(PRE_SCORE_STATE_KEY)
        except KeyError:
            selectors = []
        if not selectors:
            return 0, None
        count = sum(
            1
            for pi in node_info.pods
            if pi.pod.namespace == pod.namespace
            and pi.pod.metadata.deletion_timestamp is None
            and any(sel.matches(pi.pod.metadata.labels) for sel in selectors)
        )
        return count, None

    def score_extensions(self):
        return _Normalize(self.handle)


class _Normalize(ScoreExtensions):
    def __init__(self, handle):
        self.handle = handle

    def normalize_score(self, state, pod, scores: List[NodeScore]):
        """Invert raw match counts, blending per-node and per-zone counts
        (selector_spread.go NormalizeScore; zone weighted 2/3)."""
        snapshot = self.handle.snapshot()
        zone_counts = {}
        have_zones = False
        for s in scores:
            ni = snapshot.get(s.name)
            if ni is None or ni.node is None:
                continue
            zone = get_zone_key(ni.node)
            if zone:
                have_zones = True
                zone_counts[zone] = zone_counts.get(zone, 0) + s.score
        max_count = max((s.score for s in scores), default=0)
        max_zone = max(zone_counts.values(), default=0)
        for s in scores:
            # fewer same-selector pods -> higher score
            score = (
                MAX_NODE_SCORE * (max_count - s.score) / max_count
                if max_count > 0
                else MAX_NODE_SCORE
            )
            if have_zones:
                ni = snapshot.get(s.name)
                zone = get_zone_key(ni.node) if ni and ni.node else ""
                zone_score = MAX_NODE_SCORE
                if zone and max_zone > 0:
                    zone_score = (
                        MAX_NODE_SCORE * (max_zone - zone_counts.get(zone, 0)) / max_zone
                    )
                score = score * (1 - ZONE_WEIGHTING) + ZONE_WEIGHTING * zone_score
            s.score = int(score)
        return None
