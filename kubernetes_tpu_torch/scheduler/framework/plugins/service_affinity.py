"""ServiceAffinity, PreFilter, Filter and Score (a legacy plugin, reached
only through a Policy's ``TestServiceAffinity``; upstream
``plugins/serviceaffinity/service_affinity.go``): a pod of a Service
(read from the store) goes only to nodes that carry every label of
``affinityLabels`` with the values of the nodes its Service's placed pods
are on (the first such pod fixes each label); Score counts the Service's
pods on each node, reversed and scaled to [0, 100] (spreading, when
``antiAffinityLabelsPreference`` is set)."""

from typing import List, Optional, Tuple

from kubernetes_tpu_torch.api.labels import Selector
from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.scheduler.framework.interface import (
    MAX_NODE_SCORE,
    UNSCHEDULABLE,
    UNSCHEDULABLE_AND_UNRESOLVABLE,
    FilterPlugin,
    NodeScore,
    PreFilterExtensions,
    PreFilterPlugin,
    ScoreExtensions,
    ScorePlugin,
    Status,
)
from kubernetes_tpu_torch.scheduler.framework.plugins.helpers import default_normalize_score
from kubernetes_tpu_torch.scheduler.types import NodeInfo

PRE_FILTER_STATE_KEY = "PreFilterServiceAffinity"
ERR_REASON = "node(s) didn't match service affinity"


class _State:
    __slots__ = ("matching_pods",)

    def __init__(self, matching_pods: List[Pod]):
        self.matching_pods = matching_pods

    def clone(self):
        return _State(list(self.matching_pods))


class ServiceAffinity(PreFilterPlugin, FilterPlugin, ScorePlugin):
    NAME = "ServiceAffinity"

    @staticmethod
    def factory(args, handle):
        return ServiceAffinity(handle, args or {})

    def __init__(self, handle=None, args=None):
        args = args or {}
        self.handle = handle
        self.affinity_labels = list(args.get("affinityLabels") or [])
        self.anti_affinity_labels_preference = list(
            args.get("antiAffinityLabelsPreference") or []
        )

    def _service_selectors(self, pod: Pod) -> List[Selector]:
        out = []
        for svc in self.handle.client.list_services(pod.namespace):
            sel = Selector.from_map(svc.selector)
            if not sel.is_empty() and sel.matches(pod.metadata.labels):
                out.append(sel)
        return out

    def pre_filter(self, state, pod: Pod) -> Optional[Status]:
        selectors = self._service_selectors(pod)
        matching: List[Pod] = []
        if selectors:
            for ni in self.handle.snapshot().list():
                for pi in ni.pods:
                    p = pi.pod
                    if p.namespace == pod.namespace and any(
                        sel.matches(p.metadata.labels) for sel in selectors
                    ):
                        matching.append(p)
        state.write(PRE_FILTER_STATE_KEY, _State(matching))
        return None

    def pre_filter_extensions(self):
        return _Extensions(self)

    def filter(self, state, pod: Pod, node_info: NodeInfo) -> Optional[Status]:
        if not self.affinity_labels:
            return None
        if node_info.node is None:
            return Status(UNSCHEDULABLE_AND_UNRESOLVABLE, "node not found")
        try:
            s: _State = state.read(PRE_FILTER_STATE_KEY)
        except KeyError:
            return Status(1, "reading ServiceAffinity prefilter state")
        snapshot = self.handle.snapshot()
        # the label values the service's existing pods pin (first pod wins,
        # matching the reference's "first pod determines placement" model)
        pinned = {}
        for p in s.matching_pods:
            if not p.spec.node_name:
                continue
            ni = snapshot.get(p.spec.node_name)
            if ni is None or ni.node is None:
                continue
            for label in self.affinity_labels:
                if label not in pinned and label in ni.node.metadata.labels:
                    pinned[label] = ni.node.metadata.labels[label]
        labels = node_info.node.metadata.labels
        for label in self.affinity_labels:
            if label not in labels:
                return Status(UNSCHEDULABLE, ERR_REASON)
            if label in pinned and labels[label] != pinned[label]:
                return Status(UNSCHEDULABLE, ERR_REASON)
        return None

    def score(self, state, pod: Pod, node_name: str) -> Tuple[int, Optional[Status]]:
        node_info = self.handle.snapshot().get(node_name)
        if node_info is None or node_info.node is None:
            return 0, Status(1, f"node {node_name} not found")
        if not self.anti_affinity_labels_preference:
            return 0, None
        selectors = self._service_selectors(pod)
        if not selectors:
            return 0, None
        count = sum(
            1
            for pi in node_info.pods
            if pi.pod.namespace == pod.namespace
            and any(sel.matches(pi.pod.metadata.labels) for sel in selectors)
        )
        return count, None

    def score_extensions(self):
        return _Normalize()


class _Normalize(ScoreExtensions):
    def normalize_score(self, state, pod, scores: List[NodeScore]):
        default_normalize_score(MAX_NODE_SCORE, True, scores)
        return None


class _Extensions(PreFilterExtensions):
    def __init__(self, plugin: ServiceAffinity):
        self.plugin = plugin

    def add_pod(self, state, pod_to_schedule, pod_to_add, node_info):
        s: _State = state.read(PRE_FILTER_STATE_KEY)
        selectors = self.plugin._service_selectors(pod_to_schedule)
        if pod_to_add.namespace == pod_to_schedule.namespace and any(
            sel.matches(pod_to_add.metadata.labels) for sel in selectors
        ):
            s.matching_pods.append(pod_to_add)
        return None

    def remove_pod(self, state, pod_to_schedule, pod_to_remove, node_info):
        s: _State = state.read(PRE_FILTER_STATE_KEY)
        s.matching_pods = [
            p for p in s.matching_pods if p.uid != pod_to_remove.uid
        ]
        return None
