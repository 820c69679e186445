"""TTL controller (node annotations).

The reference's ``pkg/controller/ttl`` (ttl_controller.go): every node
is annotated with ``node.alpha.kubernetes.io/ttl``, the secret and
configmap cache TTL its kubelet should use, longer in a larger cluster
(``ttlBoundaries``: 0 s up to 100 nodes, 15 s up to 500, 30 s up to
1,000, 60 s up to 2,000, 300 s past that).
"""

from __future__ import annotations

from kubernetes_tpu_torch.api.types import Node
from kubernetes_tpu_torch.controllers.base import Controller

TTL_ANNOTATION = "node.alpha.kubernetes.io/ttl"

# (largest cluster size, ttl seconds): ttl_controller.go ttlBoundaries
_BOUNDARIES = ((100, 0), (500, 15), (1000, 30), (2000, 60))
_MAX_TTL = 300


def ttl_for_cluster_size(n: int) -> int:
    for bound, ttl in _BOUNDARIES:
        if n <= bound:
            return ttl
    return _MAX_TTL


class TTLController(Controller):
    name = "ttl"

    def register(self) -> None:
        self._last_ttl = None
        self.factory.informer_for("Node").add_event_handler(
            on_add=lambda n: self._maybe_resync(new_node=n.name),
            on_delete=lambda n: self._maybe_resync(),
        )

    def _maybe_resync(self, new_node: str = "") -> None:
        """Every node is queued only when the size crossed a boundary (as
        the reference: queueing n nodes on each of n adds is quadratic at
        bootstrap); otherwise only a new node, for its annotation."""
        ttl = ttl_for_cluster_size(len(self.store.list_nodes()))
        if ttl != self._last_ttl:
            self._last_ttl = ttl
            for n in self.store.list_nodes():
                self.enqueue_key(n.name)
        elif new_node:
            self.enqueue_key(new_node)

    def sync(self, key: str) -> None:
        want = str(ttl_for_cluster_size(len(self.store.list_nodes())))

        def mutate(n: Node) -> bool:
            if n.metadata.annotations.get(TTL_ANNOTATION) == want:
                return False
            n.metadata.annotations = dict(n.metadata.annotations)
            n.metadata.annotations[TTL_ANNOTATION] = want
            return True

        self.store.mutate_object("Node", "", key, mutate)
