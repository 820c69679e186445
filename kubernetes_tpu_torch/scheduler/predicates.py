"""The node-static predicates the encoder evaluates once per (static
profile, node), and the filter plugins evaluate per node: node selector
and required node affinity, taints and tolerations, the unschedulable
flag, and the node-affinity term match that preferred node affinity
scores with."""

from __future__ import annotations

from typing import Optional

from kubernetes_tpu_torch.api.types import (
    NO_EXECUTE,
    NO_SCHEDULE,
    TAINT_NODE_UNSCHEDULABLE,
    Node,
    NodeSelector,
    NodeSelectorTerm,
    Pod,
    Taint,
)


def node_selector_term_matches(term: NodeSelectorTerm, node: Node) -> bool:
    """A term with no expressions and no fields matches nothing."""
    if not term.match_expressions and not term.match_fields:
        return False
    for req in term.match_expressions:
        if not req.to_requirement().matches(node.metadata.labels):
            return False
    for req in term.match_fields:
        # the only supported field is metadata.name
        if req.key != "metadata.name":
            return False
        if not req.to_requirement().matches({"metadata.name": node.name}):
            return False
    return True


def node_matches_node_selector(node: Node,
                               selector: Optional[NodeSelector]) -> bool:
    """ORed terms; a nil selector matches everything."""
    if selector is None:
        return True
    return any(node_selector_term_matches(t, node)
               for t in selector.node_selector_terms)


def pod_matches_node_selector_and_affinity(pod: Pod, node: Node) -> bool:
    """Both the nodeSelector map and required node affinity must hold."""
    for k, v in pod.spec.node_selector.items():
        if node.metadata.labels.get(k) != v:
            return False
    aff = pod.spec.affinity
    if aff is not None and aff.node_affinity is not None:
        return node_matches_node_selector(
            node,
            aff.node_affinity.required_during_scheduling_ignored_during_execution)
    return True


def is_hard_taint(taint: Taint) -> bool:
    """A taint filtering pods out (NoSchedule, NoExecute)."""
    return taint.effect in (NO_SCHEDULE, NO_EXECUTE)


def find_untolerated_taint(taints, tolerations, effect_filter
                           ) -> Optional[Taint]:
    """The first taint passing ``effect_filter`` that no toleration
    tolerates, or None."""
    for taint in taints:
        if not effect_filter(taint):
            continue
        if not any(t.tolerates(taint) for t in tolerations):
            return taint
    return None


def tolerates_node_taints(pod: Pod, node: Node) -> bool:
    """Every NoSchedule / NoExecute taint is tolerated."""
    return find_untolerated_taint(node.spec.taints, pod.spec.tolerations,
                                  is_hard_taint) is None


def passes_unschedulable(pod: Pod, node: Node) -> bool:
    """A cordoned node admits only pods tolerating the unschedulable
    taint."""
    if not node.spec.unschedulable:
        return True
    taint = Taint(TAINT_NODE_UNSCHEDULABLE, "", NO_SCHEDULE)
    return any(t.tolerates(taint) for t in pod.spec.tolerations)
