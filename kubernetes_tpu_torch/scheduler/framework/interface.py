"""Scheduling-framework plugin interfaces and status codes: the extension
points (QueueSort, PreFilter with its add/remove-pod extensions, Filter,
PostFilter, PreScore, Score with normalize, Reserve, Permit, PreBind,
Bind, PostBind), the status code lattice (preemption relies on telling
``Unschedulable`` from ``UnschedulableAndUnresolvable``), the score bounds
and ``FitError``, whose message users read on the pod's condition."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.scheduler.types import NodeInfo, QueuedPodInfo

SUCCESS = 0
ERROR = 1
UNSCHEDULABLE = 2
UNSCHEDULABLE_AND_UNRESOLVABLE = 3
WAIT = 4
SKIP = 5

_CODE_NAMES = {
    SUCCESS: "Success",
    ERROR: "Error",
    UNSCHEDULABLE: "Unschedulable",
    UNSCHEDULABLE_AND_UNRESOLVABLE: "UnschedulableAndUnresolvable",
    WAIT: "Wait",
    SKIP: "Skip",
}

MAX_NODE_SCORE = 100
MIN_NODE_SCORE = 0


class Status:
    """A plugin's result. ``None`` stands for Success everywhere."""

    __slots__ = ("code", "reasons", "failed_plugin")

    def __init__(self, code: int = SUCCESS, *reasons: str,
                 failed_plugin: str = ""):
        self.code = code
        self.reasons = list(reasons)
        self.failed_plugin = failed_plugin

    @staticmethod
    def is_ok(s: Optional["Status"]) -> bool:
        return s is None or s.code == SUCCESS

    def is_success(self) -> bool:
        return self.code == SUCCESS

    def is_unschedulable(self) -> bool:
        return self.code in (UNSCHEDULABLE, UNSCHEDULABLE_AND_UNRESOLVABLE)

    def code_name(self) -> str:
        return _CODE_NAMES.get(self.code, str(self.code))

    def message(self) -> str:
        return ", ".join(self.reasons)

    def with_failed_plugin(self, name: str) -> "Status":
        self.failed_plugin = name
        return self

    def as_error(self) -> Exception:
        return RuntimeError(self.message() or self.code_name())

    def __repr__(self):
        return f"Status({self.code_name()}, {self.reasons!r})"

    def __eq__(self, other):
        if other is None:
            return self.code == SUCCESS
        return (isinstance(other, Status) and self.code == other.code
                and self.reasons == other.reasons)


NodeToStatusMap = Dict[str, Status]


@dataclass
class NodeScore:
    name: str
    score: int


@dataclass
class PostFilterResult:
    nominated_node_name: str = ""


@dataclass
class FitError(Exception):
    """No node fits: the per-node filter statuses preemption and the
    pod's condition read. A set ``message`` is returned as is (the batch
    path shares one statuses map, and one message, over many pods);
    otherwise the reasons are counted over the nodes and listed in
    sorted order."""

    pod: Pod = None
    num_all_nodes: int = 0
    filtered_nodes_statuses: NodeToStatusMap = field(default_factory=dict)
    message: str = ""

    def __str__(self):
        if self.message:
            return self.message
        reasons: Dict[str, int] = {}
        for s in self.filtered_nodes_statuses.values():
            for r in s.reasons:
                reasons[r] = reasons.get(r, 0) + 1
        parts = [f"{n} {m}" for m, n in
                 sorted(reasons.items(), key=lambda kv: kv[0])]
        self.message = (
            f"0/{self.num_all_nodes} nodes are available: "
            f"{', '.join(parts)}." if parts
            else f"0/{self.num_all_nodes} nodes are available.")
        return self.message


class Plugin:
    """Base plugin; subclasses override the extension points they
    implement. ``NAME`` is the plugin's name in the wiring."""

    NAME = "Plugin"

    def name(self) -> str:
        return self.NAME


class QueueSortPlugin(Plugin):
    def less(self, a: QueuedPodInfo, b: QueuedPodInfo) -> bool:
        raise NotImplementedError


class PreFilterExtensions:
    """Incremental PreFilter-state updates for nominated pods and
    preemption victims."""

    def add_pod(self, state, pod_to_schedule: Pod, pod_to_add: Pod,
                node_info: NodeInfo) -> Optional[Status]:
        return None

    def remove_pod(self, state, pod_to_schedule: Pod, pod_to_remove: Pod,
                   node_info: NodeInfo) -> Optional[Status]:
        return None


class PreFilterPlugin(Plugin):
    def pre_filter(self, state, pod: Pod) -> Optional[Status]:
        raise NotImplementedError

    def pre_filter_extensions(self) -> Optional[PreFilterExtensions]:
        return None


class FilterPlugin(Plugin):
    def filter(self, state, pod: Pod, node_info: NodeInfo
               ) -> Optional[Status]:
        raise NotImplementedError


class PostFilterPlugin(Plugin):
    def post_filter(self, state, pod: Pod,
                    filtered_node_status_map: NodeToStatusMap):
        """Returns (PostFilterResult or None, Status)."""
        raise NotImplementedError


class PreScorePlugin(Plugin):
    def pre_score(self, state, pod: Pod, nodes: List) -> Optional[Status]:
        raise NotImplementedError


class ScoreExtensions:
    def normalize_score(self, state, pod: Pod,
                        scores: List[NodeScore]) -> Optional[Status]:
        return None


class ScorePlugin(Plugin):
    def score(self, state, pod: Pod, node_name: str):
        """Returns (int score, Status)."""
        raise NotImplementedError

    def score_extensions(self) -> Optional[ScoreExtensions]:
        return None


class ReservePlugin(Plugin):
    def reserve(self, state, pod: Pod, node_name: str) -> Optional[Status]:
        return None

    def unreserve(self, state, pod: Pod, node_name: str) -> None:
        return None


class PermitPlugin(Plugin):
    def permit(self, state, pod: Pod, node_name: str):
        """Returns (Status, timeout seconds)."""
        raise NotImplementedError


class PreBindPlugin(Plugin):
    def pre_bind(self, state, pod: Pod, node_name: str) -> Optional[Status]:
        raise NotImplementedError


class BindPlugin(Plugin):
    def bind(self, state, pod: Pod, node_name: str) -> Optional[Status]:
        """A Skip status hands the pod to the next bind plugin."""
        raise NotImplementedError


class PostBindPlugin(Plugin):
    def post_bind(self, state, pod: Pod, node_name: str) -> None:
        raise NotImplementedError
