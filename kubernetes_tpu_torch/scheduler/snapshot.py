"""Per-cycle cluster view: node-info map, the zone-interleaved node list
(its order is the encoder's node-column order, so it decides which node
wins a score tie) and the sublist of nodes whose pods carry required
anti-affinity."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.scheduler.types import ImageStateSummary, NodeInfo

ZONE_LABELS = (
    "topology.kubernetes.io/zone",
    "failure-domain.beta.kubernetes.io/zone",
)
REGION_LABELS = (
    "topology.kubernetes.io/region",
    "failure-domain.beta.kubernetes.io/region",
)


def get_zone_key(node: Node) -> str:
    labels = node.metadata.labels
    region = next((labels[k] for k in REGION_LABELS if k in labels), "")
    zone = next((labels[k] for k in ZONE_LABELS if k in labels), "")
    if not region and not zone:
        return ""
    return f"{region}:\x00:{zone}"


class NodeTree:
    """zone -> node names, listed round-robin across zones in the order
    zones and nodes were first added."""

    def __init__(self):
        self._tree: Dict[str, List[str]] = {}
        self._zones: List[str] = []
        self.num_nodes = 0

    def add_node(self, node: Node) -> None:
        zone = get_zone_key(node)
        if zone not in self._tree:
            self._tree[zone] = []
            self._zones.append(zone)
        if node.name in self._tree[zone]:
            return
        self._tree[zone].append(node.name)
        self.num_nodes += 1

    def remove_node(self, node: Node) -> bool:
        zone = get_zone_key(node)
        names = self._tree.get(zone)
        if not names or node.name not in names:
            return False
        names.remove(node.name)
        if not names:
            del self._tree[zone]
            self._zones.remove(zone)
        self.num_nodes -= 1
        return True

    def update_node(self, old: Node, new: Node) -> None:
        if get_zone_key(old) != get_zone_key(new):
            self.remove_node(old)
            self.add_node(new)

    def list(self) -> List[str]:
        out: List[str] = []
        idx = [0] * len(self._zones)
        remaining = self.num_nodes
        while remaining > 0:
            for zi, zone in enumerate(self._zones):
                names = self._tree[zone]
                if idx[zi] < len(names):
                    out.append(names[idx[zi]])
                    idx[zi] += 1
                    remaining -= 1
        return out


class Snapshot:
    def __init__(self):
        self.node_info_map: Dict[str, NodeInfo] = {}
        self.node_info_list: List[NodeInfo] = []
        self.have_pods_with_affinity_node_info_list: List[NodeInfo] = []
        self.have_pods_with_required_anti_affinity_node_info_list: List[
            NodeInfo] = []
        self.generation: int = 0

    def list(self) -> List[NodeInfo]:
        return self.node_info_list

    def have_pods_with_affinity_list(self) -> List[NodeInfo]:
        return self.have_pods_with_affinity_node_info_list

    def have_pods_with_required_anti_affinity_list(self) -> List[NodeInfo]:
        return self.have_pods_with_required_anti_affinity_node_info_list

    def get(self, node_name: str) -> Optional[NodeInfo]:
        return self.node_info_map.get(node_name)

    def num_nodes(self) -> int:
        return len(self.node_info_list)


def new_snapshot(pods: Iterable[Pod], nodes: Iterable[Node]) -> Snapshot:
    """A coherent snapshot straight from object lists (nodes in the given
    order), with cluster-wide image states."""
    nodes = list(nodes)
    s = Snapshot()
    by_name: Dict[str, NodeInfo] = {}
    for node in nodes:
        ni = NodeInfo()
        ni.set_node(node)
        by_name[node.name] = ni
    for pod in pods:
        if pod.spec.node_name in by_name:
            by_name[pod.spec.node_name].add_pod(pod)
    image_nodes: Dict[str, set] = {}
    image_size: Dict[str, int] = {}
    for node in nodes:
        for img in node.status.images:
            for name in img.names:
                image_nodes.setdefault(name, set()).add(node.name)
                image_size[name] = img.size_bytes
    for node in nodes:
        for img in node.status.images:
            for name in img.names:
                by_name[node.name].image_states[name] = ImageStateSummary(
                    image_size[name], len(image_nodes[name]))
    s.node_info_map = by_name
    s.node_info_list = list(by_name.values())
    s.have_pods_with_affinity_node_info_list = [
        ni for ni in s.node_info_list if ni.pods_with_affinity]
    s.have_pods_with_required_anti_affinity_node_info_list = [
        ni for ni in s.node_info_list if ni.pods_with_required_anti_affinity]
    return s
