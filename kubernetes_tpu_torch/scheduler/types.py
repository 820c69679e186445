"""Scheduler-internal types: resource vectors, pre-parsed pods, per-node
aggregates and queue bookkeeping. The encoder flattens exactly these
aggregates into the dense arrays the solve kernel reads."""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from kubernetes_tpu_torch.api import labels as labelslib
from kubernetes_tpu_torch.api.types import (
    CPU,
    DEFAULT_MEMORY_REQUEST,
    DEFAULT_MILLI_CPU_REQUEST,
    EPHEMERAL_STORAGE,
    MEMORY,
    PODS,
    Node,
    Pod,
    PodAffinityTerm,
)

# monotonic generation counter shared by every NodeInfo: the cache's
# incremental snapshot copies only nodes newer than the snapshot
_generation = itertools.count(1)
_generation_lock = threading.Lock()


def next_generation() -> int:
    with _generation_lock:
        return next(_generation)


@dataclass
class Resource:
    """Aggregate resource vector: milli-CPU, bytes, pod slots and whole
    units of scalar (extended) resources."""

    milli_cpu: int = 0
    memory: int = 0
    ephemeral_storage: int = 0
    allowed_pod_number: int = 0
    scalar_resources: Dict[str, int] = field(default_factory=dict)

    @classmethod
    def from_resource_list(cls, rl: Dict) -> "Resource":
        r = cls()
        for name, q in (rl or {}).items():
            if name == CPU:
                r.milli_cpu = q.milli_value()
            elif name == MEMORY:
                r.memory = q.value()
            elif name == EPHEMERAL_STORAGE:
                r.ephemeral_storage = q.value()
            elif name == PODS:
                r.allowed_pod_number = q.value()
            else:
                r.scalar_resources[name] = q.value()
        return r

    def add(self, other: "Resource") -> None:
        self.milli_cpu += other.milli_cpu
        self.memory += other.memory
        self.ephemeral_storage += other.ephemeral_storage
        for k, v in other.scalar_resources.items():
            self.scalar_resources[k] = self.scalar_resources.get(k, 0) + v

    def sub(self, other: "Resource") -> None:
        self.milli_cpu -= other.milli_cpu
        self.memory -= other.memory
        self.ephemeral_storage -= other.ephemeral_storage
        for k, v in other.scalar_resources.items():
            self.scalar_resources[k] = self.scalar_resources.get(k, 0) - v

    def set_max(self, other: "Resource") -> None:
        self.milli_cpu = max(self.milli_cpu, other.milli_cpu)
        self.memory = max(self.memory, other.memory)
        self.ephemeral_storage = max(self.ephemeral_storage,
                                     other.ephemeral_storage)
        for k, v in other.scalar_resources.items():
            self.scalar_resources[k] = max(self.scalar_resources.get(k, 0), v)

    def clone(self) -> "Resource":
        return Resource(self.milli_cpu, self.memory, self.ephemeral_storage,
                        self.allowed_pod_number, dict(self.scalar_resources))


def compute_pod_resource_request(pod: Pod, non_zero: bool = False
                                 ) -> Resource:
    """max(sum of app containers, max of init containers) + overhead. The
    ``non_zero`` variant gives containers without a CPU or memory request
    the 100m / 200Mi defaults that scoring uses."""
    spec = pod.spec
    result = Resource()
    for c in spec.containers:
        result.add(_container_request(c, non_zero))
    init_max = Resource()
    for c in spec.init_containers:
        init_max.set_max(_container_request(c, non_zero))
    result.set_max(init_max)
    if spec.overhead:
        result.add(Resource.from_resource_list(spec.overhead))
    result.allowed_pod_number = 0
    return result


def _container_request(container, non_zero: bool) -> Resource:
    r = Resource.from_resource_list(container.resources.requests)
    if non_zero:
        if CPU not in container.resources.requests:
            r.milli_cpu = DEFAULT_MILLI_CPU_REQUEST
        if MEMORY not in container.resources.requests:
            r.memory = DEFAULT_MEMORY_REQUEST
    return r


@dataclass(frozen=True)
class AffinityTerm:
    """A pre-parsed (anti-)affinity term."""

    namespaces: frozenset
    selector: labelslib.Selector
    topology_key: str

    def matches(self, pod: Pod) -> bool:
        return pod.namespace in self.namespaces and self.selector.matches(
            pod.metadata.labels)


@dataclass(frozen=True)
class WeightedAffinityTerm:
    term: AffinityTerm
    weight: int


def _make_term(pod: Pod, term: PodAffinityTerm) -> AffinityTerm:
    namespaces = set(term.namespaces) if term.namespaces else {pod.namespace}
    return AffinityTerm(
        frozenset(namespaces),
        labelslib.selector_from_label_selector(term.label_selector),
        term.topology_key,
    )


class PodInfo:
    """A pod with its parsed affinity terms and resource requests."""

    __slots__ = (
        "pod", "required_affinity_terms", "required_anti_affinity_terms",
        "preferred_affinity_terms", "preferred_anti_affinity_terms",
        "resource_request", "non_zero_request",
    )

    @classmethod
    def of(cls, pod: Pod) -> "PodInfo":
        """Memoized on the pod object. Stored pods are immutable: every
        revision is a fresh object, so the memo never goes stale."""
        pi = pod.__dict__.get("_pod_info")
        if pi is None or pi.pod is not pod:
            pi = cls(pod)
            pod.__dict__["_pod_info"] = pi
        return pi

    @classmethod
    def derived(cls, pod: Pod, base: "PodInfo") -> "PodInfo":
        """PodInfo for a shallow variant of ``base.pod`` that differs only
        in spec.nodeName (the assumed copy): shares the parse."""
        pi = cls.__new__(cls)
        pi.pod = pod
        for name in cls.__slots__[1:]:
            setattr(pi, name, getattr(base, name))
        pod.__dict__["_pod_info"] = pi
        return pi

    def __init__(self, pod: Pod):
        self.pod = pod
        self.required_affinity_terms: List[AffinityTerm] = []
        self.required_anti_affinity_terms: List[AffinityTerm] = []
        self.preferred_affinity_terms: List[WeightedAffinityTerm] = []
        self.preferred_anti_affinity_terms: List[WeightedAffinityTerm] = []
        aff = pod.spec.affinity
        if aff is not None:
            for src, req, pref in (
                (aff.pod_affinity, self.required_affinity_terms,
                 self.preferred_affinity_terms),
                (aff.pod_anti_affinity, self.required_anti_affinity_terms,
                 self.preferred_anti_affinity_terms),
            ):
                if src is None:
                    continue
                for t in src.required_during_scheduling_ignored_during_execution:
                    req.append(_make_term(pod, t))
                for wt in src.preferred_during_scheduling_ignored_during_execution:
                    pref.append(WeightedAffinityTerm(
                        _make_term(pod, wt.pod_affinity_term), wt.weight))
        self.resource_request = compute_pod_resource_request(pod)
        self.non_zero_request = compute_pod_resource_request(
            pod, non_zero=True)


class QueuedPodInfo:
    """Queue bookkeeping around a PodInfo: the enqueue timestamp the queue
    orders by, the attempt count, and the first enqueue time."""

    __slots__ = ("pod_info", "timestamp", "attempts",
                 "initial_attempt_timestamp")

    def __init__(self, pod: Pod, timestamp: Optional[float] = None):
        now = time.monotonic() if timestamp is None else timestamp
        self.pod_info = PodInfo.of(pod)
        self.timestamp = now
        self.attempts = 0
        self.initial_attempt_timestamp = now

    @property
    def pod(self) -> Pod:
        return self.pod_info.pod


@dataclass
class ImageStateSummary:
    size: int = 0
    num_nodes: int = 0


# a used host port: (host IP, protocol, port)
PortKey = Tuple[str, str, int]


def pod_host_ports(pod: Pod) -> List[PortKey]:
    out = []
    for c in pod.spec.containers:
        for p in c.ports:
            if p.host_port > 0:
                out.append((p.host_ip or "0.0.0.0", p.protocol or "TCP",
                            p.host_port))
    return out


def ports_conflict(used: Set[PortKey], wanted: List[PortKey]) -> bool:
    """0.0.0.0 conflicts with any IP on the same (protocol, port)."""
    if not wanted or not used:
        return False
    for ip, proto, port in wanted:
        for uip, uproto, uport in used:
            if proto == uproto and port == uport:
                if ip == "0.0.0.0" or uip == "0.0.0.0" or ip == uip:
                    return True
    return False


class NodeInfo:
    """Aggregated per-node scheduling state."""

    __slots__ = (
        "node", "pods", "pods_with_affinity",
        "pods_with_required_anti_affinity", "used_ports", "requested",
        "non_zero_requested", "allocatable", "image_states", "generation",
    )

    def __init__(self):
        self.node: Optional[Node] = None
        self.pods: List[PodInfo] = []
        self.pods_with_affinity: List[PodInfo] = []
        self.pods_with_required_anti_affinity: List[PodInfo] = []
        self.used_ports: Set[PortKey] = set()
        self.requested = Resource()
        self.non_zero_requested = Resource()
        self.allocatable = Resource()
        self.image_states: Dict[str, ImageStateSummary] = {}
        self.generation = next_generation()

    def set_node(self, node: Node) -> None:
        self.node = node
        self.allocatable = Resource.from_resource_list(node.status.allocatable)
        self.generation = next_generation()

    def remove_node(self) -> None:
        """The node is gone; its pods stay until their own deletions."""
        self.node = None
        self.generation = next_generation()

    def add_pod(self, pod: Pod) -> None:
        self.add_pod_info(PodInfo.of(pod))

    def add_pod_info(self, pi: PodInfo) -> None:
        self.pods.append(pi)
        if _pod_with_affinity(pi):
            self.pods_with_affinity.append(pi)
        if pi.required_anti_affinity_terms:
            self.pods_with_required_anti_affinity.append(pi)
        self.requested.add(pi.resource_request)
        self.non_zero_requested.add(pi.non_zero_request)
        self.used_ports.update(pod_host_ports(pi.pod))
        self.generation = next_generation()

    def remove_pod(self, pod: Pod) -> bool:
        for i, pi in enumerate(self.pods):
            if pi.pod.uid == pod.uid:
                self.pods.pop(i)
                self.pods_with_affinity = [
                    x for x in self.pods_with_affinity
                    if x.pod.uid != pod.uid]
                self.pods_with_required_anti_affinity = [
                    x for x in self.pods_with_required_anti_affinity
                    if x.pod.uid != pod.uid]
                self.requested.sub(pi.resource_request)
                self.non_zero_requested.sub(pi.non_zero_request)
                self.used_ports = set()
                for x in self.pods:
                    self.used_ports.update(pod_host_ports(x.pod))
                self.generation = next_generation()
                return True
        return False

    def clone(self) -> "NodeInfo":
        c = NodeInfo()
        c.copy_from(self)
        return c

    def copy_from(self, other: "NodeInfo") -> None:
        """Overwrite in place: the snapshot's map and ordered list share
        NodeInfo objects, so an incremental update must not replace them."""
        self.node = other.node
        self.pods = list(other.pods)
        self.pods_with_affinity = list(other.pods_with_affinity)
        self.pods_with_required_anti_affinity = list(
            other.pods_with_required_anti_affinity)
        self.used_ports = set(other.used_ports)
        self.requested = other.requested.clone()
        self.non_zero_requested = other.non_zero_requested.clone()
        self.allocatable = other.allocatable.clone()
        self.image_states = dict(other.image_states)
        self.generation = other.generation


def _pod_with_affinity(pi: PodInfo) -> bool:
    return bool(pi.required_affinity_terms or pi.required_anti_affinity_terms
                or pi.preferred_affinity_terms
                or pi.preferred_anti_affinity_terms)


def get_pod_key(pod: Pod) -> str:
    return pod.uid
