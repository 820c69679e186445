"""Shared plugin helpers: node-selector and node-affinity matching (the
encoder's own predicates, one copy for both paths) and the default
min-max score normalizer."""

from __future__ import annotations

from typing import List

from kubernetes_tpu_torch.scheduler.framework.interface import NodeScore
from kubernetes_tpu_torch.scheduler.predicates import (  # noqa: F401
    node_matches_node_selector,
    node_selector_term_matches,
    pod_matches_node_selector_and_affinity,
)


def default_normalize_score(max_priority: int, reverse: bool,
                            scores: List[NodeScore]) -> None:
    """Scale raw scores into [0, max_priority] by the max; optionally
    reverse."""
    max_count = max((s.score for s in scores), default=0)
    if max_count == 0:
        if reverse:
            for s in scores:
                s.score = max_priority
        return
    for s in scores:
        score = s.score * max_priority // max_count
        s.score = max_priority - score if reverse else score
