"""Fluent builders for test pods/nodes.

Same role as the reference's ``pkg/scheduler/testing/wrappers.go``
(``MakePod():140``, ``MakeNode():401``): table-driven tests construct
objects with chained calls instead of nested literals.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from kubernetes_tpu_torch.api.labels import LabelSelector, Requirement
from kubernetes_tpu_torch.api.resource import parse_quantity
from kubernetes_tpu_torch.api.types import (
    Affinity,
    Container,
    ContainerPort,
    Node,
    NodeAffinity,
    NodeSelector,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    Pod,
    PodAffinity,
    PodAffinityTerm,
    PreferredSchedulingTerm,
    ResourceRequirements,
    Taint,
    Toleration,
    TopologySpreadConstraint,
    Volume,
    WeightedPodAffinityTerm,
)


class PodWrapper:
    def __init__(self):
        self.pod = Pod()

    def obj(self) -> Pod:
        return self.pod

    def name(self, n: str) -> "PodWrapper":
        self.pod.metadata.name = n
        return self

    def namespace(self, ns: str) -> "PodWrapper":
        self.pod.metadata.namespace = ns
        return self

    def uid(self, u: str) -> "PodWrapper":
        self.pod.metadata.uid = u
        return self

    def label(self, k: str, v: str) -> "PodWrapper":
        self.pod.metadata.labels[k] = v
        return self

    def labels(self, m: Dict[str, str]) -> "PodWrapper":
        self.pod.metadata.labels.update(m)
        return self

    def container(self, image: str = "image", name: str = "") -> "PodWrapper":
        self.pod.spec.containers.append(
            Container(name=name or f"c{len(self.pod.spec.containers)}", image=image)
        )
        return self

    def req(self, resources: Dict[str, str]) -> "PodWrapper":
        """Add a container with the given resource requests."""
        self.pod.spec.containers.append(
            Container(
                name=f"c{len(self.pod.spec.containers)}",
                resources=ResourceRequirements(
                    requests={k: parse_quantity(v) for k, v in resources.items()}
                ),
            )
        )
        return self

    def init_req(self, resources: Dict[str, str]) -> "PodWrapper":
        self.pod.spec.init_containers.append(
            Container(
                name=f"init{len(self.pod.spec.init_containers)}",
                resources=ResourceRequirements(
                    requests={k: parse_quantity(v) for k, v in resources.items()}
                ),
            )
        )
        return self

    def overhead(self, resources: Dict[str, str]) -> "PodWrapper":
        self.pod.spec.overhead = {k: parse_quantity(v) for k, v in resources.items()}
        return self

    def host_port(self, port: int, protocol: str = "TCP", host_ip: str = "") -> "PodWrapper":
        if not self.pod.spec.containers:
            self.container()
        self.pod.spec.containers[-1].ports.append(
            ContainerPort(container_port=port, host_port=port, protocol=protocol, host_ip=host_ip)
        )
        return self

    def node(self, name: str) -> "PodWrapper":
        self.pod.spec.node_name = name
        return self

    def node_selector(self, m: Dict[str, str]) -> "PodWrapper":
        self.pod.spec.node_selector = dict(m)
        return self

    def priority(self, p: int) -> "PodWrapper":
        self.pod.spec.priority = p
        return self

    def scheduler_name(self, n: str) -> "PodWrapper":
        self.pod.spec.scheduler_name = n
        return self

    def phase(self, p: str) -> "PodWrapper":
        self.pod.status.phase = p
        return self

    def nominated_node_name(self, n: str) -> "PodWrapper":
        self.pod.status.nominated_node_name = n
        return self

    def terminating(self, ts: float = 1.0) -> "PodWrapper":
        self.pod.metadata.deletion_timestamp = ts
        return self

    def toleration(self, key: str, value: str = "", effect: str = "",
                   operator: str = "Equal") -> "PodWrapper":
        self.pod.spec.tolerations.append(
            Toleration(key=key, operator=operator, value=value, effect=effect)
        )
        return self

    def _affinity(self) -> Affinity:
        if self.pod.spec.affinity is None:
            self.pod.spec.affinity = Affinity()
        return self.pod.spec.affinity

    def node_affinity_in(self, key: str, vals: List[str]) -> "PodWrapper":
        aff = self._affinity()
        if aff.node_affinity is None:
            aff.node_affinity = NodeAffinity()
        if aff.node_affinity.required_during_scheduling_ignored_during_execution is None:
            aff.node_affinity.required_during_scheduling_ignored_during_execution = (
                NodeSelector([NodeSelectorTerm()])
            )
        aff.node_affinity.required_during_scheduling_ignored_during_execution.\
            node_selector_terms[0].match_expressions.append(
                NodeSelectorRequirement(key, "In", list(vals))
            )
        return self

    def preferred_node_affinity(self, weight: int, key: str, vals: List[str]) -> "PodWrapper":
        aff = self._affinity()
        if aff.node_affinity is None:
            aff.node_affinity = NodeAffinity()
        aff.node_affinity.preferred_during_scheduling_ignored_during_execution.append(
            PreferredSchedulingTerm(
                weight,
                NodeSelectorTerm(
                    match_expressions=[NodeSelectorRequirement(key, "In", list(vals))]
                ),
            )
        )
        return self

    def _pod_affinity_term(self, key: str, vals: List[str], topology_key: str) -> PodAffinityTerm:
        return PodAffinityTerm(
            label_selector=LabelSelector(
                match_expressions=[Requirement(key, "In", tuple(vals))]
            ),
            topology_key=topology_key,
        )

    def pod_affinity(self, key: str, vals: List[str], topology_key: str) -> "PodWrapper":
        aff = self._affinity()
        if aff.pod_affinity is None:
            aff.pod_affinity = PodAffinity()
        aff.pod_affinity.required_during_scheduling_ignored_during_execution.append(
            self._pod_affinity_term(key, vals, topology_key)
        )
        return self

    def pod_anti_affinity(self, key: str, vals: List[str], topology_key: str) -> "PodWrapper":
        aff = self._affinity()
        if aff.pod_anti_affinity is None:
            aff.pod_anti_affinity = PodAffinity()
        aff.pod_anti_affinity.required_during_scheduling_ignored_during_execution.append(
            self._pod_affinity_term(key, vals, topology_key)
        )
        return self

    def preferred_pod_affinity(self, weight: int, key: str, vals: List[str],
                               topology_key: str) -> "PodWrapper":
        aff = self._affinity()
        if aff.pod_affinity is None:
            aff.pod_affinity = PodAffinity()
        aff.pod_affinity.preferred_during_scheduling_ignored_during_execution.append(
            WeightedPodAffinityTerm(weight, self._pod_affinity_term(key, vals, topology_key))
        )
        return self

    def preferred_pod_anti_affinity(self, weight: int, key: str, vals: List[str],
                                    topology_key: str) -> "PodWrapper":
        aff = self._affinity()
        if aff.pod_anti_affinity is None:
            aff.pod_anti_affinity = PodAffinity()
        aff.pod_anti_affinity.preferred_during_scheduling_ignored_during_execution.append(
            WeightedPodAffinityTerm(weight, self._pod_affinity_term(key, vals, topology_key))
        )
        return self

    def spread_constraint(self, max_skew: int, topology_key: str,
                          when_unsatisfiable: str,
                          selector: Optional[Dict[str, str]] = None) -> "PodWrapper":
        self.pod.spec.topology_spread_constraints.append(
            TopologySpreadConstraint(
                max_skew=max_skew,
                topology_key=topology_key,
                when_unsatisfiable=when_unsatisfiable,
                label_selector=LabelSelector(match_labels=dict(selector or {})),
            )
        )
        return self

    def pvc(self, claim_name: str) -> "PodWrapper":
        self.pod.spec.volumes.append(
            Volume(name=f"vol{len(self.pod.spec.volumes)}",
                   persistent_volume_claim=claim_name)
        )
        return self

    def owner_reference(self, kind: str, name: str, uid: str = "",
                        controller: bool = True) -> "PodWrapper":
        self.pod.metadata.owner_references.append(
            {"kind": kind, "name": name, "uid": uid or f"{kind}-{name}",
             "controller": controller}
        )
        return self


class NodeWrapper:
    def __init__(self):
        self.node = Node()
        self.capacity({"pods": "110"})

    def obj(self) -> Node:
        return self.node

    def name(self, n: str) -> "NodeWrapper":
        self.node.metadata.name = n
        # kubernetes.io/hostname is implied by node identity in the reference;
        # tests rely on it for hostname topology.
        self.node.metadata.labels.setdefault("kubernetes.io/hostname", n)
        return self

    def label(self, k: str, v: str) -> "NodeWrapper":
        self.node.metadata.labels[k] = v
        return self

    def capacity(self, resources: Dict[str, str]) -> "NodeWrapper":
        for k, v in resources.items():
            q = parse_quantity(v)
            self.node.status.capacity[k] = q
            self.node.status.allocatable[k] = q
        return self

    def allocatable(self, resources: Dict[str, str]) -> "NodeWrapper":
        for k, v in resources.items():
            self.node.status.allocatable[k] = parse_quantity(v)
        return self

    def taint(self, key: str, value: str = "", effect: str = "NoSchedule") -> "NodeWrapper":
        self.node.spec.taints.append(Taint(key, value, effect))
        return self

    def unschedulable(self, v: bool = True) -> "NodeWrapper":
        self.node.spec.unschedulable = v
        return self

    def image(self, name: str, size_bytes: int) -> "NodeWrapper":
        from kubernetes_tpu_torch.api.types import ContainerImage

        self.node.status.images.append(ContainerImage([name], size_bytes))
        return self


def MakePod() -> PodWrapper:
    return PodWrapper()


def MakeNode() -> NodeWrapper:
    return NodeWrapper()
