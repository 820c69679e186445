"""NodePreferAvoidPods score (reference
``plugins/nodepreferavoidpods/node_prefer_avoid_pods.go``): node annotation
``scheduler.alpha.kubernetes.io/preferAvoidPods`` lists controllers whose
pods should avoid the node; weight 10000 in the default provider
(registry.go:126) so it dominates other scores."""

import json
from typing import Optional, Tuple

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.scheduler.framework.interface import (
    MAX_NODE_SCORE,
    ScorePlugin,
    Status,
)

ANNOTATION_KEY = "scheduler.alpha.kubernetes.io/preferAvoidPods"


class NodePreferAvoidPods(ScorePlugin):
    NAME = "NodePreferAvoidPods"

    @staticmethod
    def factory(args, handle):
        return NodePreferAvoidPods(handle)

    def __init__(self, handle=None):
        self.handle = handle

    def score(self, state, pod: Pod, node_name: str) -> Tuple[int, Optional[Status]]:
        node_info = self.handle.snapshot().get(node_name)
        if node_info is None or node_info.node is None:
            return 0, Status(1, f"node {node_name} not found")
        node = node_info.node
        controller = None
        for ref in pod.metadata.owner_references:
            if ref.get("controller") or ref.get("kind") in (
                "ReplicationController",
                "ReplicaSet",
            ):
                controller = ref
                break
        if controller is None:
            return MAX_NODE_SCORE, None
        raw = node.metadata.annotations.get(ANNOTATION_KEY)
        if not raw:
            return MAX_NODE_SCORE, None
        try:
            avoids = json.loads(raw).get("preferAvoidPods", [])
        except (ValueError, AttributeError):
            return MAX_NODE_SCORE, None
        for avoid in avoids:
            ref = (avoid.get("podSignature") or {}).get("podController") or {}
            if ref.get("kind") == controller.get("kind") and (
                not ref.get("uid") or ref.get("uid") == controller.get("uid")
            ):
                return 0, None
        return MAX_NODE_SCORE, None
