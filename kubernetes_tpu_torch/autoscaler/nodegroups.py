"""Node groups and the simulated cloud provisioner.

A ``NodeGroup`` is a node template (capacity, labels, taints) with size
bounds (cloudprovider.NodeGroup); membership is the node's
``cluster-autoscaler.kubernetes.io/node-group`` label, so statically
created nodes can join a group. The ``SimulatedProvisioner`` plays the
cloud: it adds real ``Node`` objects to the store after the group's boot
latency and deletes them on scale-down, so the scheduler's cache and
queue see ordinary node events."""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

from kubernetes_tpu_torch.api.resource import parse_quantity
from kubernetes_tpu_torch.api.types import Node, Taint

NODE_GROUP_LABEL = "cluster-autoscaler.kubernetes.io/node-group"
# the opt-in for evicting a pod without a controller during a drain
SAFE_TO_EVICT_ANNOTATION = "cluster-autoscaler.kubernetes.io/safe-to-evict"


@dataclass
class NodeGroup:
    """One node template with scaling bounds."""

    name: str
    cpu: str = "32"
    memory: str = "64Gi"
    max_pods: int = 110
    labels: Dict[str, str] = field(default_factory=dict)
    taints: List[Taint] = field(default_factory=list)
    min_size: int = 0
    max_size: int = 10
    priority: int = 0          # read by the "priority" expander
    boot_latency: float = 0.0  # seconds from provision to the node's add

    def node_template(self, index) -> Node:
        """A node of this group named ``{name}-{index}`` (the what-if's
        virtual nodes take names that never reach the store)."""
        name = f"{self.name}-{index}"
        node = Node()
        node.metadata.name = name
        node.metadata.labels.update({
            "kubernetes.io/hostname": name,
            NODE_GROUP_LABEL: self.name,
        })
        node.metadata.labels.update(self.labels)
        for key, value in (("cpu", self.cpu), ("memory", self.memory),
                           ("pods", str(self.max_pods))):
            node.status.allocatable[key] = parse_quantity(value)
        node.spec.taints = [Taint(t.key, t.value, t.effect)
                            for t in self.taints]
        return node


class NodeGroupRegistry:
    """Groups by name, and a node's group."""

    def __init__(self, groups: Optional[List[NodeGroup]] = None):
        self._groups: Dict[str, NodeGroup] = {}
        for g in groups or ():
            self.add(g)

    def add(self, group: NodeGroup) -> NodeGroup:
        self._groups[group.name] = group
        return group

    def get(self, name: str) -> Optional[NodeGroup]:
        return self._groups.get(name)

    def __iter__(self) -> Iterator[NodeGroup]:
        return iter([self._groups[n] for n in sorted(self._groups)])

    def __len__(self) -> int:
        return len(self._groups)

    @staticmethod
    def group_of(node: Node) -> Optional[str]:
        return node.metadata.labels.get(NODE_GROUP_LABEL)


class SimulatedProvisioner:
    """Adds a group's nodes to the store after its boot latency (one
    worker thread over a heap of ready times; a latency of 0 adds them
    at once, in the caller) and deletes them on scale-down. Store calls
    are made without this object's lock held: the store delivers watch
    events synchronously, and a handler may ask the provisioner."""

    def __init__(self, store, registry: NodeGroupRegistry):
        self._store = store
        self._registry = registry
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # (ready at, seq, group name, node)
        self._boot_heap: List[Tuple[float, int, str, Node]] = []
        # popped (or provisioned at once) but not added to the store yet:
        # still booting to every reader, so no scale-up buys them twice
        self._registering: List[Tuple[str, Node]] = []
        self._seq = itertools.count()
        self._next_index: Dict[str, int] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.provisioned_total = 0

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="node-provisioner")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _ensure_index_seed(self, group: NodeGroup) -> None:
        """Start the group's name counter past its existing members (read
        without the lock, see the class)."""
        with self._lock:
            if group.name in self._next_index:
                return
        prefix = f"{group.name}-"
        nxt = 0
        for node in self._store.list_nodes():
            if NodeGroupRegistry.group_of(node) != group.name:
                continue
            suffix = node.name[len(prefix):] \
                if node.name.startswith(prefix) else ""
            if suffix.isdigit():
                nxt = max(nxt, int(suffix) + 1)
        with self._lock:
            self._next_index.setdefault(group.name, nxt)

    def live_count(self, group_name: str) -> int:
        return sum(1 for n in self._store.list_nodes()
                   if NodeGroupRegistry.group_of(n) == group_name)

    def booting_count(self, group_name: str) -> int:
        with self._lock:
            return sum(1 for _, _, g, _ in self._boot_heap
                       if g == group_name) \
                + sum(1 for g, _ in self._registering if g == group_name)

    def group_size(self, group_name: str) -> int:
        """Booting plus live (the target size the max-size cap and the
        headroom respect). Booting is read first: a node registering
        between the reads is counted twice, never in neither."""
        return self.booting_count(group_name) + self.live_count(group_name)

    def booting_templates(self, group_name: Optional[str] = None
                          ) -> List[Node]:
        """Nodes provisioned but not added yet: the what-if counts them
        as upcoming capacity, or every pass would buy them again."""
        with self._lock:
            return [node for _, _, g, node in self._boot_heap
                    if group_name is None or g == group_name] + [
                node for g, node in self._registering
                if group_name is None or g == group_name]

    def provision(self, group: NodeGroup, count: int) -> List[str]:
        """Start ``count`` nodes of ``group``; returns their names. Each
        is added to the store after ``group.boot_latency``."""
        names: List[str] = []
        immediate: List[Node] = []
        self._ensure_index_seed(group)
        ready_at = time.monotonic() + group.boot_latency
        with self._cond:
            for _ in range(max(0, count)):
                index = self._next_index.get(group.name, 0)
                self._next_index[group.name] = index + 1
                node = group.node_template(index)
                names.append(node.name)
                if group.boot_latency <= 0:
                    immediate.append(node)
                    self._registering.append((group.name, node))
                else:
                    heapq.heappush(self._boot_heap, (
                        ready_at, next(self._seq), group.name, node))
            self._cond.notify_all()
        for node in immediate:
            self._register(node)
            with self._lock:
                self._registering.remove((group.name, node))
        return names

    def deprovision(self, node_name: str) -> None:
        self._store.delete_node(node_name)

    def _register(self, node: Node) -> None:
        self._store.add_node(node)
        self.provisioned_total += 1

    def _loop(self) -> None:
        while not self._stop.is_set():
            with self._cond:
                if not self._boot_heap:
                    self._cond.wait(0.5)
                    continue
                now = time.monotonic()
                ready_at = self._boot_heap[0][0]
                if ready_at > now:
                    self._cond.wait(min(ready_at - now, 0.5))
                    continue
                _, _, gname, node = heapq.heappop(self._boot_heap)
                self._registering.append((gname, node))
            self._register(node)
            with self._lock:
                self._registering.remove((gname, node))
