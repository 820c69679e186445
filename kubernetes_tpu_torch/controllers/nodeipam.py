"""Node IPAM controller.

The reference's ``pkg/controller/nodeipam`` range allocator: each new
node gets a pod CIDR (``node.spec.podCIDR``) cut from the cluster CIDR,
and a deleted node's block goes back to be handed out first. The default
is kubeadm's ``--pod-network-cidr=10.244.0.0/16`` in /24 blocks.
"""

from __future__ import annotations

import ipaddress
import threading

from kubernetes_tpu_torch.api.types import Node, shallow_copy
from kubernetes_tpu_torch.controllers.base import Controller


class NodeIpamController(Controller):
    name = "nodeipam"

    cluster_cidr = "10.244.0.0/16"
    node_mask = 24

    def register(self) -> None:
        # cluster-scoped: keyed by the bare name
        self.factory.informer_for("Node").add_event_handler(
            on_add=lambda n: self.enqueue_key(n.name),
            on_update=lambda old, new: self.enqueue_key(new.name),
            on_delete=self._release,
        )
        self._alloc_lock = threading.Lock()
        self._subnets = ipaddress.ip_network(self.cluster_cidr).subnets(
            new_prefix=self.node_mask)
        self._free: list = []       # released blocks, handed out first
        self._in_use: dict = {}     # cidr -> node name
        self._adopted = False

    def _claim(self, node_name: str) -> str:
        with self._alloc_lock:
            # the assignments already in the store, once (a restart)
            if not self._adopted:
                self._adopted = True
                for n in self.store.list_nodes():
                    if n.spec.pod_cidr and n.spec.pod_cidr not in self._in_use:
                        self._in_use[n.spec.pod_cidr] = n.name
            if self._free:
                cidr = self._free.pop()
            else:
                for subnet in self._subnets:
                    cidr = str(subnet)
                    if cidr not in self._in_use:
                        break
                else:
                    raise RuntimeError(
                        f"cluster CIDR {self.cluster_cidr} exhausted")
            self._in_use[cidr] = node_name
            return cidr

    def _release(self, node: Node) -> None:
        if not node.spec.pod_cidr:
            return
        with self._alloc_lock:
            if self._in_use.pop(node.spec.pod_cidr, None) is not None:
                self._free.append(node.spec.pod_cidr)

    def sync(self, key: str) -> None:
        node = self.store.get_node(key)
        if node is None or node.spec.pod_cidr:
            return
        updated = shallow_copy(node)
        updated.spec = shallow_copy(node.spec)
        updated.spec.pod_cidr = self._claim(node.name)
        self.store.update_node(updated)
