"""ImageLocality score (reference
``plugins/imagelocality/image_locality.go``): prefers nodes that already
hold the pod's container images, scaled by image size and how widely the
image is spread across nodes."""

from typing import Optional, Tuple

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.scheduler.framework.interface import (
    MAX_NODE_SCORE,
    ScorePlugin,
    Status,
)
from kubernetes_tpu_torch.scheduler.types import NodeInfo

MB = 1024 * 1024
MIN_THRESHOLD = 23 * MB
MAX_CONTAINER_THRESHOLD = 1000 * MB


class ImageLocality(ScorePlugin):
    NAME = "ImageLocality"

    @staticmethod
    def factory(args, handle):
        return ImageLocality(handle)

    def __init__(self, handle=None):
        self.handle = handle

    def score(self, state, pod: Pod, node_name: str) -> Tuple[int, Optional[Status]]:
        snapshot = self.handle.snapshot()
        node_info = snapshot.get(node_name)
        if node_info is None or node_info.node is None:
            return 0, Status(1, f"node {node_name} not found")
        total_nodes = snapshot.num_nodes()
        if total_nodes == 0:
            return 0, None
        sum_scores = _sum_image_scores(node_info, pod, total_nodes)
        max_threshold = MAX_CONTAINER_THRESHOLD * max(len(pod.spec.containers), 1)
        score = int(
            MAX_NODE_SCORE
            * _clamp01((sum_scores - MIN_THRESHOLD) / (max_threshold - MIN_THRESHOLD))
        )
        return score, None


def _sum_image_scores(node_info: NodeInfo, pod: Pod, total_nodes: int) -> float:
    total = 0.0
    for container in pod.spec.containers:
        state = _lookup_image(node_info, container.image)
        if state is not None:
            # spread ratio dampens hotspots on rarely-pulled images
            total += state.size * (state.num_nodes / total_nodes)
    return total


def _lookup_image(node_info: NodeInfo, image: str):
    if not image:
        return None
    candidates = [image]
    if ":" not in image.rsplit("/", 1)[-1]:
        candidates.append(image + ":latest")
    for name in candidates:
        if name in node_info.image_states:
            return node_info.image_states[name]
    return None


def _clamp01(x: float) -> float:
    return 0.0 if x < 0 else (1.0 if x > 1 else x)
