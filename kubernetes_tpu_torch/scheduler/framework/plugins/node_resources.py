"""NodeResources plugin family (reference ``plugins/noderesources/``):

- ``Fit`` — PreFilter+Filter feasibility: pod request vector
  (max(sum(containers), init) + overhead, fit.go:148-165) vs
  ``allocatable − requested`` per resource, plus the pod-count cap
  (fit.go:230-302).
- ``BalancedAllocation`` — ``(1 − |cpuFrac − memFrac|)·100``
  (balanced_allocation.go:82-112).
- ``LeastAllocated`` — free capacity fraction averaged over cpu+mem.

Scoring uses non-zero requests (100m/200Mi floors) like the reference's
``resource_allocation.go`` scaffold; Fit uses actual requests.
"""

from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.scheduler.framework.interface import (
    MAX_NODE_SCORE,
    UNSCHEDULABLE,
    UNSCHEDULABLE_AND_UNRESOLVABLE,
    FilterPlugin,
    PreFilterPlugin,
    ScorePlugin,
    Status,
)
from kubernetes_tpu_torch.scheduler.types import (
    NodeInfo,
    Resource,
    compute_pod_resource_request,
)

PRE_FILTER_STATE_KEY = "PreFilterNodeResourcesFit"


class Fit(PreFilterPlugin, FilterPlugin):
    NAME = "NodeResourcesFit"

    @staticmethod
    def factory(args, handle):
        return Fit(args or {})

    def __init__(self, args=None):
        args = args or {}
        self.ignored_resources = set(args.get("ignoredResources") or [])
        self.ignored_resource_groups = set(args.get("ignoredResourceGroups") or [])

    def pre_filter(self, state, pod: Pod) -> Optional[Status]:
        state.write(PRE_FILTER_STATE_KEY, compute_pod_resource_request(pod))
        return None

    def filter(self, state, pod: Pod, node_info: NodeInfo) -> Optional[Status]:
        if node_info.node is None:
            return Status(UNSCHEDULABLE_AND_UNRESOLVABLE, "node not found")
        try:
            request: Resource = state.read(PRE_FILTER_STATE_KEY)
        except KeyError:
            request = compute_pod_resource_request(pod)
        reasons = fits_request(
            request, node_info, self.ignored_resources, self.ignored_resource_groups
        )
        if reasons:
            return Status(UNSCHEDULABLE, *reasons)
        return None


def fits_request(
    request: Resource,
    node_info: NodeInfo,
    ignored_resources=frozenset(),
    ignored_groups=frozenset(),
) -> List[str]:
    """Returns insufficient-resource reasons (fit.go:230-302)."""
    reasons: List[str] = []
    allowed = node_info.allocatable.allowed_pod_number
    if len(node_info.pods) + 1 > allowed > 0:
        reasons.append("Too many pods")
    if (
        request.milli_cpu == 0
        and request.memory == 0
        and request.ephemeral_storage == 0
        and not request.scalar_resources
    ):
        return reasons
    alloc, used = node_info.allocatable, node_info.requested
    if request.milli_cpu > alloc.milli_cpu - used.milli_cpu:
        reasons.append("Insufficient cpu")
    if request.memory > alloc.memory - used.memory:
        reasons.append("Insufficient memory")
    if request.ephemeral_storage > alloc.ephemeral_storage - used.ephemeral_storage:
        reasons.append("Insufficient ephemeral-storage")
    for name, quantity in request.scalar_resources.items():
        if name in ignored_resources:
            continue
        if "/" in name and name.split("/", 1)[0] in ignored_groups:
            continue
        if quantity > alloc.scalar_resources.get(name, 0) - used.scalar_resources.get(
            name, 0
        ):
            reasons.append(f"Insufficient {name}")
    return reasons


class _ResourceAllocationScorer(ScorePlugin):
    """Shared scaffold (resource_allocation.go): assemble per-resource
    (requested-including-this-pod, allocatable) pairs using non-zero
    requests, then delegate to a shaping function."""

    resources: Dict[str, int] = {"cpu": 1, "memory": 1}

    def __init__(self, handle=None):
        self.handle = handle

    def score(self, state, pod: Pod, node_name: str) -> Tuple[int, Optional[Status]]:
        node_info = self.handle.snapshot().get(node_name)
        if node_info is None or node_info.node is None:
            return 0, Status(1, f"node {node_name} not found")
        pod_request = compute_pod_resource_request(pod, non_zero=True)
        requested, allocatable = {}, {}
        for name in self.resources:
            if name == "cpu":
                requested[name] = node_info.non_zero_requested.milli_cpu + pod_request.milli_cpu
                allocatable[name] = node_info.allocatable.milli_cpu
            elif name == "memory":
                requested[name] = node_info.non_zero_requested.memory + pod_request.memory
                allocatable[name] = node_info.allocatable.memory
            else:
                requested[name] = node_info.requested.scalar_resources.get(
                    name, 0
                ) + pod_request.scalar_resources.get(name, 0)
                allocatable[name] = node_info.allocatable.scalar_resources.get(name, 0)
        return self._score_from_fractions(requested, allocatable), None

    def _score_from_fractions(self, requested, allocatable) -> int:
        raise NotImplementedError


class BalancedAllocation(_ResourceAllocationScorer):
    NAME = "NodeResourcesBalancedAllocation"

    @staticmethod
    def factory(args, handle):
        return BalancedAllocation(handle)

    def _score_from_fractions(self, requested, allocatable) -> int:
        fractions = []
        for name in self.resources:
            if allocatable[name] == 0:
                return 0
            f = requested[name] / allocatable[name]
            if f >= 1.0:
                # over-committed on a dimension: worst balance
                return 0
            fractions.append(f)
        diff = abs(fractions[0] - fractions[1])
        return int((1.0 - diff) * MAX_NODE_SCORE)


class LeastAllocated(_ResourceAllocationScorer):
    NAME = "NodeResourcesLeastAllocated"

    @staticmethod
    def factory(args, handle):
        p = LeastAllocated(handle)
        p._load_weights(args)
        return p

    def _load_weights(self, args):
        if args and args.get("resources"):
            self.resources = {
                r["name"]: int(r.get("weight", 1)) for r in args["resources"]
            }

    def _score_from_fractions(self, requested, allocatable) -> int:
        total, weight_sum = 0, 0
        for name, weight in self.resources.items():
            if allocatable[name] == 0:
                continue
            free = max(0, allocatable[name] - requested[name])
            total += weight * free * MAX_NODE_SCORE // allocatable[name]
            weight_sum += weight
        return total // weight_sum if weight_sum else 0


class MostAllocated(LeastAllocated):
    """The bin-packing score of the cluster autoscaler provider: the
    used share of each resource, weighted and averaged."""

    NAME = "NodeResourcesMostAllocated"

    @staticmethod
    def factory(args, handle):
        p = MostAllocated(handle)
        p._load_weights(args)
        return p

    def _score_from_fractions(self, requested, allocatable) -> int:
        total, weight_sum = 0, 0
        for name, weight in self.resources.items():
            if allocatable[name] == 0:
                continue
            used = min(requested[name], allocatable[name])
            total += weight * used * MAX_NODE_SCORE // allocatable[name]
            weight_sum += weight
        return total // weight_sum if weight_sum else 0


class RequestedToCapacityRatio(_ResourceAllocationScorer):
    """A piecewise-linear score of each resource's utilization (args
    ``shape``: utilization -> score points on a 0-10 scale; ``resources``:
    names and weights), weighted, averaged and scaled to [0, 100]. Reached
    through a Policy's RequestedToCapacityRatioPriority."""

    NAME = "RequestedToCapacityRatio"

    points: List[Tuple[int, int]] = [(0, 0), (100, 10)]

    @staticmethod
    def factory(args, handle):
        p = RequestedToCapacityRatio(handle)
        args = args or {}
        shape = args.get("shape") or [
            {"utilization": 0, "score": 0},
            {"utilization": 100, "score": 10},
        ]
        p.points = sorted(
            (int(s["utilization"]), int(s["score"])) for s in shape)
        if args.get("resources"):
            p.resources = {
                r["name"]: int(r.get("weight", 1)) for r in args["resources"]
            }
        return p

    def _piecewise(self, utilization: float) -> float:
        pts = self.points
        if utilization <= pts[0][0]:
            return pts[0][1]
        for (x0, y0), (x1, y1) in zip(pts, pts[1:]):
            if utilization <= x1:
                return y0 + (y1 - y0) * (utilization - x0) / (x1 - x0)
        return pts[-1][1]

    def _score_from_fractions(self, requested, allocatable) -> int:
        total, weight_sum = 0.0, 0
        for name, weight in self.resources.items():
            if allocatable[name] == 0:
                continue
            utilization = min(100.0,
                              100.0 * requested[name] / allocatable[name])
            total += weight * self._piecewise(utilization)
            weight_sum += weight
        if weight_sum == 0:
            return 0
        return int(total / weight_sum * MAX_NODE_SCORE / 10)
