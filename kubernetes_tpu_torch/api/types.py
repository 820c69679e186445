"""The scheduling slice of the core/v1 object model: Pod, Node and what
scheduling reads from them, as plain dataclasses with ``from_dict``
constructors that take Kubernetes-manifest-shaped dicts; and the storage
objects the volume plugins read (PersistentVolumeClaim,
PersistentVolume, StorageClass, CSINode) and the controller objects
SelectorSpread reads (Service, ReplicaSet, ReplicationController,
StatefulSet), built in code; and the kinds the apiserver's RBAC,
admission and discovery read (the RBAC roles and bindings, Namespace,
ServiceAccount, PriorityClass, ResourceQuota, Lease)."""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional

from kubernetes_tpu_torch.api.labels import LabelSelector, Requirement, Selector
from kubernetes_tpu_torch.api.resource import Quantity, parse_quantity

CPU = "cpu"
MEMORY = "memory"
EPHEMERAL_STORAGE = "ephemeral-storage"
PODS = "pods"
# the non-zero request defaults scoring uses for containers without requests
DEFAULT_MILLI_CPU_REQUEST = 100
DEFAULT_MEMORY_REQUEST = 200 * 1024 * 1024

NO_SCHEDULE = "NoSchedule"
PREFER_NO_SCHEDULE = "PreferNoSchedule"
NO_EXECUTE = "NoExecute"
TAINT_NODE_UNSCHEDULABLE = "node.kubernetes.io/unschedulable"
TAINT_NODE_UNREACHABLE = "node.kubernetes.io/unreachable"

PENDING, RUNNING, SUCCEEDED, FAILED = (
    "Pending", "Running", "Succeeded", "Failed")

_uid_counter = itertools.count(1)


def shallow_copy(obj):
    """Shallow copy of a plain dataclass through its ``__dict__``."""
    new = object.__new__(type(obj))
    new.__dict__.update(obj.__dict__)
    return new


def new_uid() -> str:
    return f"uid-{next(_uid_counter)}"


def _parse_resource_list(d: Optional[Mapping]) -> Dict[str, Quantity]:
    return {k: parse_quantity(v) for k, v in (d or {}).items()}


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = field(default_factory=new_uid)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    resource_version: str = ""
    deletion_timestamp: Optional[float] = None
    owner_references: List[dict] = field(default_factory=list)
    # wall-clock seconds; the store stamps a pod's on create
    creation_timestamp: float = 0.0
    finalizers: List[str] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Mapping) -> "ObjectMeta":
        return cls(
            name=d.get("name", ""),
            namespace=d.get("namespace", "default"),
            uid=d.get("uid") or new_uid(),
            labels=dict(d.get("labels") or ()),
            annotations=dict(d.get("annotations") or ()),
            owner_references=list(d.get("ownerReferences") or ()),
            finalizers=list(d.get("finalizers") or ()),
        )


@dataclass
class ContainerPort:
    container_port: int = 0
    host_port: int = 0
    protocol: str = "TCP"
    host_ip: str = ""

    @classmethod
    def from_dict(cls, d: Mapping) -> "ContainerPort":
        return cls(int(d.get("containerPort") or 0),
                   int(d.get("hostPort") or 0),
                   d.get("protocol") or "TCP",
                   d.get("hostIP") or "")


@dataclass
class ResourceRequirements:
    requests: Dict[str, Quantity] = field(default_factory=dict)
    # read only by an extender's ``managedResources`` interest
    limits: Dict[str, Quantity] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Optional[Mapping]) -> "ResourceRequirements":
        d = d or {}
        return cls(_parse_resource_list(d.get("requests")),
                   _parse_resource_list(d.get("limits")))


@dataclass
class Container:
    name: str = ""
    image: str = ""
    resources: ResourceRequirements = field(
        default_factory=ResourceRequirements)
    ports: List[ContainerPort] = field(default_factory=list)
    image_pull_policy: str = ""
    lifecycle: Optional[Dict[str, Any]] = None

    @classmethod
    def from_dict(cls, d: Mapping) -> "Container":
        return cls(
            name=d.get("name", ""),
            image=d.get("image", ""),
            resources=ResourceRequirements.from_dict(d.get("resources")),
            ports=[ContainerPort.from_dict(p) for p in d.get("ports") or ()],
            image_pull_policy=d.get("imagePullPolicy", ""),
            lifecycle=d.get("lifecycle"),
        )


@dataclass
class NodeSelectorRequirement:
    key: str
    operator: str
    values: List[str] = field(default_factory=list)

    def to_requirement(self) -> Requirement:
        return Requirement(self.key, self.operator, tuple(self.values))

    @classmethod
    def from_dict(cls, d: Mapping) -> "NodeSelectorRequirement":
        return cls(d["key"], d["operator"], list(d.get("values") or []))


@dataclass
class NodeSelectorTerm:
    match_expressions: List[NodeSelectorRequirement] = field(
        default_factory=list)
    match_fields: List[NodeSelectorRequirement] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Mapping) -> "NodeSelectorTerm":
        return cls(
            [NodeSelectorRequirement.from_dict(e)
             for e in d.get("matchExpressions") or ()],
            [NodeSelectorRequirement.from_dict(e)
             for e in d.get("matchFields") or ()],
        )


@dataclass
class NodeSelector:
    """ORed terms; each term's expressions and fields are ANDed."""

    node_selector_terms: List[NodeSelectorTerm] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Optional[Mapping]) -> Optional["NodeSelector"]:
        if d is None:
            return None
        return cls([NodeSelectorTerm.from_dict(t)
                    for t in d.get("nodeSelectorTerms") or ()])


@dataclass
class PreferredSchedulingTerm:
    weight: int
    preference: NodeSelectorTerm

    @classmethod
    def from_dict(cls, d: Mapping) -> "PreferredSchedulingTerm":
        return cls(int(d["weight"]),
                   NodeSelectorTerm.from_dict(d.get("preference") or {}))


@dataclass
class NodeAffinity:
    required_during_scheduling_ignored_during_execution: Optional[
        NodeSelector] = None
    preferred_during_scheduling_ignored_during_execution: List[
        PreferredSchedulingTerm] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Optional[Mapping]) -> Optional["NodeAffinity"]:
        if d is None:
            return None
        return cls(
            NodeSelector.from_dict(
                d.get("requiredDuringSchedulingIgnoredDuringExecution")),
            [PreferredSchedulingTerm.from_dict(t) for t in
             d.get("preferredDuringSchedulingIgnoredDuringExecution") or ()],
        )


@dataclass
class PodAffinityTerm:
    label_selector: Optional[LabelSelector] = None
    namespaces: List[str] = field(default_factory=list)
    topology_key: str = ""

    @classmethod
    def from_dict(cls, d: Mapping) -> "PodAffinityTerm":
        return cls(LabelSelector.from_dict(d.get("labelSelector")),
                   list(d.get("namespaces") or []),
                   d.get("topologyKey", ""))


@dataclass
class WeightedPodAffinityTerm:
    weight: int
    pod_affinity_term: PodAffinityTerm

    @classmethod
    def from_dict(cls, d: Mapping) -> "WeightedPodAffinityTerm":
        return cls(int(d["weight"]),
                   PodAffinityTerm.from_dict(d.get("podAffinityTerm") or {}))


@dataclass
class PodAffinity:
    required_during_scheduling_ignored_during_execution: List[
        PodAffinityTerm] = field(default_factory=list)
    preferred_during_scheduling_ignored_during_execution: List[
        WeightedPodAffinityTerm] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Optional[Mapping]) -> Optional["PodAffinity"]:
        if d is None:
            return None
        return cls(
            [PodAffinityTerm.from_dict(t) for t in
             d.get("requiredDuringSchedulingIgnoredDuringExecution") or ()],
            [WeightedPodAffinityTerm.from_dict(t) for t in
             d.get("preferredDuringSchedulingIgnoredDuringExecution") or ()],
        )


@dataclass
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAffinity] = None

    @classmethod
    def from_dict(cls, d: Optional[Mapping]) -> Optional["Affinity"]:
        if d is None:
            return None
        return cls(NodeAffinity.from_dict(d.get("nodeAffinity")),
                   PodAffinity.from_dict(d.get("podAffinity")),
                   PodAffinity.from_dict(d.get("podAntiAffinity")))


@dataclass
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # "" matches every effect
    toleration_seconds: Optional[int] = None

    def tolerates(self, taint: "Taint") -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if self.operator == "Exists":
            return True
        return self.value == taint.value

    @classmethod
    def from_dict(cls, d: Mapping) -> "Toleration":
        return cls(d.get("key", ""), d.get("operator", "Equal"),
                   d.get("value", ""), d.get("effect", ""),
                   d.get("tolerationSeconds"))


@dataclass
class Taint:
    key: str = ""
    value: str = ""
    effect: str = NO_SCHEDULE

    @classmethod
    def from_dict(cls, d: Mapping) -> "Taint":
        return cls(d.get("key", ""), d.get("value", ""),
                   d.get("effect", NO_SCHEDULE))


@dataclass
class TopologySpreadConstraint:
    max_skew: int = 1
    topology_key: str = ""
    when_unsatisfiable: str = "DoNotSchedule"  # or ScheduleAnyway
    label_selector: Optional[LabelSelector] = None

    @classmethod
    def from_dict(cls, d: Mapping) -> "TopologySpreadConstraint":
        return cls(int(d.get("maxSkew", 1)), d.get("topologyKey", ""),
                   d.get("whenUnsatisfiable", "DoNotSchedule"),
                   LabelSelector.from_dict(d.get("labelSelector")))


@dataclass
class Volume:
    """A pod volume: its name and the sources scheduling reads (a claim,
    a host path, an ephemeral volume, the inline cloud disks)."""

    name: str = ""
    persistent_volume_claim: Optional[str] = None  # claimName
    host_path: Optional[str] = None
    ephemeral: bool = False
    gce_persistent_disk: Optional[str] = None      # pdName
    aws_elastic_block_store: Optional[str] = None  # volumeID
    azure_disk: Optional[str] = None               # diskName
    rbd: Optional[dict] = None
    iscsi: Optional[dict] = None

    @classmethod
    def from_dict(cls, d: Mapping) -> "Volume":
        return cls(
            name=d.get("name", ""),
            persistent_volume_claim=(d.get("persistentVolumeClaim")
                                     or {}).get("claimName"),
            host_path=(d.get("hostPath") or {}).get("path"),
            ephemeral=bool(d.get("ephemeral")),
            gce_persistent_disk=(d.get("gcePersistentDisk")
                                 or {}).get("pdName"),
            aws_elastic_block_store=(d.get("awsElasticBlockStore")
                                     or {}).get("volumeID"),
            azure_disk=(d.get("azureDisk") or {}).get("diskName"),
            rbd=d.get("rbd"),
            iscsi=d.get("iscsi"),
        )


@dataclass
class PodSpec:
    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)
    overhead: Dict[str, Quantity] = field(default_factory=dict)
    node_name: str = ""
    node_selector: Dict[str, str] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: List[Toleration] = field(default_factory=list)
    scheduler_name: str = "default-scheduler"
    priority: Optional[int] = None
    preemption_policy: str = "PreemptLowerPriority"  # or "Never"
    topology_spread_constraints: List[TopologySpreadConstraint] = field(
        default_factory=list)
    volumes: List[Volume] = field(default_factory=list)
    # what the apiserver's admission reads: the PriorityClass that sets
    # ``priority``, and the ServiceAccount the pod runs as
    priority_class_name: str = ""
    service_account_name: str = ""
    host_network: bool = False
    restart_policy: str = "Always"
    termination_grace_period_seconds: Optional[float] = None

    @classmethod
    def from_dict(cls, d: Mapping) -> "PodSpec":
        aff = d.get("affinity")
        return cls(
            containers=[Container.from_dict(c)
                        for c in d.get("containers") or ()],
            init_containers=[Container.from_dict(c)
                             for c in d.get("initContainers") or ()],
            overhead=_parse_resource_list(d.get("overhead")),
            node_name=d.get("nodeName", ""),
            node_selector=dict(d.get("nodeSelector") or {}),
            affinity=Affinity.from_dict(aff) if aff else None,
            tolerations=[Toleration.from_dict(t)
                         for t in d.get("tolerations") or ()],
            scheduler_name=d.get("schedulerName") or "default-scheduler",
            priority=d.get("priority"),
            preemption_policy=(d.get("preemptionPolicy")
                               or "PreemptLowerPriority"),
            topology_spread_constraints=[
                TopologySpreadConstraint.from_dict(t)
                for t in d.get("topologySpreadConstraints") or ()],
            volumes=[Volume.from_dict(v) for v in d.get("volumes") or ()],
            priority_class_name=d.get("priorityClassName", ""),
            service_account_name=d.get("serviceAccountName", ""),
            host_network=bool(d.get("hostNetwork")),
            restart_policy=d.get("restartPolicy") or "Always",
            termination_grace_period_seconds=(
                float(d["terminationGracePeriodSeconds"])
                if d.get("terminationGracePeriodSeconds") is not None
                else None),
        )


@dataclass
class PodCondition:
    type: str
    status: str
    reason: str = ""
    message: str = ""


@dataclass
class PodStatus:
    phase: str = PENDING
    conditions: List[PodCondition] = field(default_factory=list)
    nominated_node_name: str = ""
    # the kubelet's status writes (``set_pod_phase``)
    pod_ip: str = ""
    host_ip: str = ""
    start_time: float = 0.0
    reason: str = ""
    message: str = ""

    @classmethod
    def from_dict(cls, d: Optional[Mapping]) -> "PodStatus":
        d = d or {}
        return cls(d.get("phase", PENDING), [],
                   d.get("nominatedNodeName", ""),
                   reason=d.get("reason", ""), message=d.get("message", ""))


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    @property
    def uid(self) -> str:
        return self.metadata.uid

    def priority(self) -> int:
        """A nil priority is 0."""
        return self.spec.priority if self.spec.priority is not None else 0

    def full_name(self) -> str:
        return f"{self.namespace}/{self.name}"

    @classmethod
    def from_dict(cls, d: Mapping) -> "Pod":
        return cls(ObjectMeta.from_dict(d.get("metadata") or {}),
                   PodSpec.from_dict(d.get("spec") or {}),
                   PodStatus.from_dict(d.get("status")))


@dataclass
class ContainerImage:
    names: List[str] = field(default_factory=list)
    size_bytes: int = 0


@dataclass
class NodeStatus:
    allocatable: Dict[str, Quantity] = field(default_factory=dict)
    images: List[ContainerImage] = field(default_factory=list)
    capacity: Dict[str, Quantity] = field(default_factory=dict)
    conditions: List[PodCondition] = field(default_factory=list)
    volumes_attached: List[str] = field(default_factory=list)  # PV names
    volumes_in_use: List[str] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Optional[Mapping]) -> "NodeStatus":
        d = d or {}
        # allocatable defaults to capacity
        capacity = _parse_resource_list(d.get("capacity"))
        allocatable = (_parse_resource_list(d.get("allocatable"))
                       or dict(capacity))
        return cls(allocatable, [
            ContainerImage(list(i.get("names") or []),
                           int(i.get("sizeBytes") or 0))
            for i in d.get("images") or ()], capacity)


@dataclass
class NodeSpec:
    unschedulable: bool = False
    taints: List[Taint] = field(default_factory=list)
    provider_id: str = ""
    pod_cidr: str = ""

    @classmethod
    def from_dict(cls, d: Optional[Mapping]) -> "NodeSpec":
        d = d or {}
        return cls(bool(d.get("unschedulable")),
                   [Taint.from_dict(t) for t in d.get("taints") or ()],
                   d.get("providerID", ""), d.get("podCIDR", ""))


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)

    @property
    def name(self) -> str:
        return self.metadata.name

    @classmethod
    def from_dict(cls, d: Mapping) -> "Node":
        return cls(ObjectMeta.from_dict(d.get("metadata") or {}),
                   NodeSpec.from_dict(d.get("spec")),
                   NodeStatus.from_dict(d.get("status")))


@dataclass
class PodDisruptionBudgetStatus:
    """What preemption reads: how many disruptions are allowed now."""

    disruptions_allowed: int = 0
    current_healthy: int = 0
    desired_healthy: int = 0
    expected_pods: int = 0


@dataclass
class PodDisruptionBudget:
    """policy/v1beta1 PodDisruptionBudget: a selector over pods and the
    budget's live status."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    label_selector: Optional[LabelSelector] = None
    min_available: Optional[object] = None     # int or "N%"
    max_unavailable: Optional[object] = None   # int or "N%"
    status: PodDisruptionBudgetStatus = field(
        default_factory=PodDisruptionBudgetStatus)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    @property
    def disruptions_allowed(self) -> int:
        return self.status.disruptions_allowed

    @property
    def selector(self) -> Selector:
        if self.label_selector is None:
            return Selector.nothing()
        return self.label_selector.to_selector()

    @classmethod
    def from_dict(cls, d: Mapping) -> "PodDisruptionBudget":
        spec = d.get("spec") or {}
        status = d.get("status") or {}
        return cls(
            ObjectMeta.from_dict(d.get("metadata") or {}),
            LabelSelector.from_dict(spec.get("selector")),
            spec.get("minAvailable"),
            spec.get("maxUnavailable"),
            PodDisruptionBudgetStatus(
                int(status.get("disruptionsAllowed") or 0),
                int(status.get("currentHealthy") or 0),
                int(status.get("desiredHealthy") or 0),
                int(status.get("expectedPods") or 0)),
        )


# ----------------------------------------------------------------------
# storage: claims, volumes, classes and the per-node CSI attach limits
@dataclass
class PersistentVolumeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    storage_class_name: Optional[str] = None
    access_modes: List[str] = field(default_factory=list)
    requests: Dict[str, Quantity] = field(default_factory=dict)
    volume_name: str = ""
    phase: str = "Pending"  # Pending | Bound | Lost

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace


@dataclass
class PersistentVolume:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    capacity: Dict[str, Quantity] = field(default_factory=dict)
    access_modes: List[str] = field(default_factory=list)
    storage_class_name: str = ""
    node_affinity: Optional[NodeSelector] = None
    claim_ref: Optional[str] = None  # "namespace/name" of the bound claim
    phase: str = "Available"
    csi_driver: str = ""  # the CSI driver serving it, if any

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class StorageClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    provisioner: str = ""
    volume_binding_mode: str = "Immediate"  # or WaitForFirstConsumer

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class CSINodeDriver:
    name: str
    node_id: str = ""
    allocatable_count: Optional[int] = None  # the attach limit, if any


@dataclass
class CSINode:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    drivers: List[CSINodeDriver] = field(default_factory=list)


# ----------------------------------------------------------------------
# the objects whose selectors SelectorSpread spreads pods by
@dataclass
class WorkloadStatus:
    """The observed state a workload controller keeps."""

    replicas: int = 0
    ready_replicas: int = 0
    observed_generation: int = 0
    succeeded: int = 0
    failed: int = 0
    completion_time: Optional[float] = None


@dataclass
class ServicePort:
    name: str = ""
    port: int = 0
    target_port: int = 0
    protocol: str = "TCP"


@dataclass
class Service:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Dict[str, str] = field(default_factory=dict)
    ports: List[ServicePort] = field(default_factory=list)
    cluster_ip: str = ""
    session_affinity: str = "None"  # None | ClientIP

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace


@dataclass
class ReplicaSet:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Optional[LabelSelector] = None
    replicas: int = 0
    template: Optional[dict] = None  # manifest-shaped pod template
    status: WorkloadStatus = field(default_factory=WorkloadStatus)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace


@dataclass
class ReplicationController:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Dict[str, str] = field(default_factory=dict)
    replicas: int = 0
    template: Optional[dict] = None
    status: WorkloadStatus = field(default_factory=WorkloadStatus)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace


@dataclass
class StatefulSet:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Optional[LabelSelector] = None
    replicas: int = 0
    template: Optional[dict] = None
    status: WorkloadStatus = field(default_factory=WorkloadStatus)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace


@dataclass
class ObjectReference:
    """A reference to another object: an Event's ``involved_object``."""

    kind: str = ""
    namespace: str = ""
    name: str = ""
    uid: str = ""


def object_reference(obj) -> ObjectReference:
    return ObjectReference(kind=type(obj).__name__,
                           namespace=getattr(obj.metadata, "namespace", ""),
                           name=obj.metadata.name, uid=obj.metadata.uid)


@dataclass
class Event:
    """A core/v1 Event: the scheduler records ``Scheduled`` on a bind,
    ``FailedScheduling`` on a failed attempt and ``Preempted`` on an
    eviction. Occurrences with the same object, type, reason and message
    aggregate into one Event with a bumped ``count``
    (``client.events.EventRecorder``)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    involved_object: ObjectReference = field(default_factory=ObjectReference)
    reason: str = ""
    message: str = ""
    type: str = "Normal"           # Normal | Warning
    count: int = 1
    first_timestamp: float = 0.0
    last_timestamp: float = 0.0
    source_component: str = ""


# ----------------------------------------------------------------------
# the objects the apiserver's RBAC bootstrap, admission and discovery
# build and read
@dataclass
class PolicyRule:
    """One grant: the cross-product of verbs and resources (with optional
    per-object names); "*" is a wildcard on either axis."""

    verbs: List[str] = field(default_factory=list)
    resources: List[str] = field(default_factory=list)
    resource_names: List[str] = field(default_factory=list)
    non_resource_urls: List[str] = field(default_factory=list)


@dataclass
class RBACSubject:
    """Who a binding grants to."""

    kind: str = "User"  # User | Group | ServiceAccount
    name: str = ""
    namespace: str = ""  # ServiceAccount subjects only


@dataclass
class RoleRef:
    kind: str = "ClusterRole"  # ClusterRole | Role
    name: str = ""


@dataclass
class Role:
    """A namespaced rule set."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    rules: List[PolicyRule] = field(default_factory=list)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace


@dataclass
class ClusterRole:
    """A cluster-wide rule set; ``aggregation_label_selectors`` (each a
    matchLabels dict) names the roles whose rules it aggregates."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    rules: List[PolicyRule] = field(default_factory=list)
    aggregation_label_selectors: List[Dict[str, str]] = field(
        default_factory=list)

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class RoleBinding:
    """Grants a Role, or a ClusterRole scoped down to this binding's
    namespace, to subjects."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    subjects: List[RBACSubject] = field(default_factory=list)
    role_ref: RoleRef = field(default_factory=RoleRef)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace


@dataclass
class ClusterRoleBinding:
    """Grants a ClusterRole cluster-wide."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    subjects: List[RBACSubject] = field(default_factory=list)
    role_ref: RoleRef = field(default_factory=RoleRef)

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class Namespace:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    phase: str = "Active"  # Active | Terminating

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class ServiceAccount:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    secrets: List[str] = field(default_factory=list)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace


@dataclass
class PriorityClass:
    """Maps ``pod.spec.priority_class_name`` to the numeric priority
    preemption orders by; one class may be the default for pods naming
    none."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    value: int = 0
    global_default: bool = False
    description: str = ""
    preemption_policy: str = "PreemptLowerPriority"  # or "Never"

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class ResourceQuota:
    """``hard`` caps what a namespace's pods may request in sum;
    ``used`` is its status."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    hard: Dict[str, Quantity] = field(default_factory=dict)
    used: Dict[str, Quantity] = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace


@dataclass
class Secret:
    """A named map of secret values, kept as plain strings (the
    reference carries base64 bytes on the wire)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    type: str = "Opaque"
    data: Dict[str, str] = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace


@dataclass
class ConfigMap:
    """A named map of configuration values."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    data: Dict[str, str] = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace


@dataclass
class Lease:
    """The read-only view of one of the store's leases."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    holder_identity: str = ""
    lease_duration_seconds: float = 0.0
    renew_time: float = 0.0

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace
