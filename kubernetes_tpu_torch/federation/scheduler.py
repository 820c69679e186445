"""Federation scheduler: clusters are what-if solve columns.

The cluster autoscaler asks "would a new node help?" by appending
virtual node columns to the encoded planes and pushing their scores
down (``ops.solver.solve_whatif``); the federation tier asks the same
question a level up, "which cluster should take this workload?", with
one synthetic node per cluster whose allocatable is the cluster's
remaining capacity (``CapacityLedger``). Penalty tiers order the
clusters as the autoscaler orders real, upcoming and virtual nodes:

    home cluster (0) < remote cluster (REMOTE_CLUSTER_PENALTY)
        < saturated cluster (SATURATION_PENALTY) < dead (disabled)

so a workload lands at home while home has room, spills to a sibling
when home saturates, and never goes to a dead cluster. A gang folds
into one unit pod with the summed request, so it is placed whole.

The decision runs on the numpy oracle (``autoscaler.simulator.
_serial_whatif``) by default, or, with ``FederationPolicy(serial=
False)``, on the scan (``solve_whatif``: the CUDA kernel on the card,
its plain PyTorch loop for ``device="cpu"``).

``place`` raises :class:`FederationUnavailable` while the layer is
marked down; the federated client then routes each pod to its home
cluster, so every cell keeps scheduling.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.autoscaler.simulator import _serial_whatif
from kubernetes_tpu_torch.device import resolve_device
from kubernetes_tpu_torch.federation.ledger import CapacityLedger
from kubernetes_tpu_torch.observability.tracer import get_tracer
from kubernetes_tpu_torch.ops.encode import BatchEncoder
from kubernetes_tpu_torch.ops.solver import SolverParams, solve_whatif
from kubernetes_tpu_torch.scheduler.framework.plugins.coscheduling import (
    GROUP_NAME_LABEL,
)
from kubernetes_tpu_torch.scheduler.snapshot import new_snapshot
from kubernetes_tpu_torch.scheduler.types import compute_pod_resource_request

GANG_NAME_LABEL = GROUP_NAME_LABEL

# Penalty tiers, in f32-safe magnitudes below the autoscaler's virtual
# node penalty (1e6): real scores are in the hundreds, remote stays far
# below saturation so a saturated home loses to a healthy sibling.
REMOTE_CLUSTER_PENALTY = 1.0e4
SATURATION_PENALTY = 5.0e5


class FederationUnavailable(RuntimeError):
    """The federation layer is down; each cell schedules locally."""


@dataclass(frozen=True)
class FederationPolicy:
    """Placement knobs of the cluster-granularity solve. ``serial``: the
    numpy oracle (a decision is a few units over a few columns); False
    asks the scan the same question."""

    remote_penalty: float = REMOTE_CLUSTER_PENALTY
    saturation_penalty: float = SATURATION_PENALTY
    saturation_threshold: float = 0.85   # utilization at which to penalize
    serial: bool = True
    pad_pods: int = 64


@dataclass
class PlacementUnit:
    """One workload placed whole: a pod, or a gang folded into one summed
    request."""

    pods: List = field(default_factory=list)
    gang: str = ""
    milli: int = 0
    mem: int = 0
    namespace: str = "default"


@dataclass
class Placement:
    """One unit's verdict: the chosen cluster (None: no live cluster
    fits, and the caller parks the unit at home, where it pends)."""

    unit: PlacementUnit
    cluster: Optional[int]
    home: Optional[int]

    @property
    def spilled(self) -> bool:
        return (self.cluster is not None and self.home is not None
                and self.cluster != self.home)


def group_units(pods: Sequence) -> List[PlacementUnit]:
    """Fold a pod batch into placement units, in order: the members of a
    gang (its ``pod-group.scheduling.k8s.io/name`` label) into one unit
    with the summed request, every other pod into its own."""
    units: List[PlacementUnit] = []
    by_gang: Dict[str, PlacementUnit] = {}
    for pod in pods:
        req = compute_pod_resource_request(pod)
        gang = (pod.metadata.labels or {}).get(GANG_NAME_LABEL, "")
        unit = by_gang.get(gang) if gang else None
        if unit is None:
            unit = PlacementUnit(
                gang=gang, namespace=pod.metadata.namespace or "default")
            if gang:
                by_gang[gang] = unit
            units.append(unit)
        unit.pods.append(pod)
        unit.milli += req.milli_cpu
        unit.mem += req.memory
    return units


class FederationScheduler:
    """Scores the clusters with the what-if solve and places units whole.
    ``device``: where a ``serial=False`` decision runs (the card unless
    "cpu"; without a card the default raises). ``decisions``, when set to
    a list, collects each solve's (cluster, batch, penalties, disabled,
    assignments)."""

    def __init__(self, ledger: CapacityLedger,
                 policy: Optional[FederationPolicy] = None,
                 home_of: Optional[Callable[[str], Optional[int]]] = None,
                 device=None):
        self.ledger = ledger
        self.policy = policy or FederationPolicy()
        self.device = resolve_device(device)
        # namespace -> home cluster (None: no affinity); the rebalancer's
        # split and move rewrite it
        self.home_of = home_of or (lambda ns: None)
        self._down = False
        self.solves = 0
        self.placed_units = 0
        self.unplaced_units = 0
        self.decisions: Optional[list] = None

    # -- the degradation switch ------------------------------------------
    def set_down(self, down: bool) -> None:
        self._down = bool(down)

    @property
    def down(self) -> bool:
        return self._down

    # -- the placement decision ------------------------------------------
    def place(self, pods: Sequence, trace_uid: str = "") -> List[Placement]:
        """One :class:`Placement` per unit of ``pods`` (gangs fold; see
        ``group_units``), under a ``fed.place`` span."""
        if self._down:
            raise FederationUnavailable("federation layer is down")
        t0 = time.monotonic()
        pods = list(pods)
        units = group_units(pods)
        by_home: Dict[Optional[int], List[PlacementUnit]] = {}
        for u in units:
            home = self.home_of(u.namespace)
            if home is not None and not self.ledger.alive(home):
                home = None
            by_home.setdefault(home, []).append(u)
        out: List[Placement] = []
        for home, group in by_home.items():
            out.extend(self._place_group(group, home))
        get_tracer().record(
            "fed.place", t0, trace=trace_uid, units=len(units),
            pods=len(pods), clusters=len(self.ledger.clusters()),
            spilled=sum(1 for p in out if p.spilled),
            unplaced=sum(1 for p in out if p.cluster is None))
        return out

    def _place_group(self, units: List[PlacementUnit],
                     home: Optional[int]) -> List[Placement]:
        """One solve for the units of one home (the penalties are per
        column, so a solve expresses one home)."""
        clusters = self.ledger.clusters()
        live = set(self.ledger.live_clusters())
        if not live:
            self.unplaced_units += len(units)
            return [Placement(unit=u, cluster=None, home=home)
                    for u in units]
        cluster, batch, col_cluster = self._encode(clusters, units)
        penalties: Dict[int, float] = {}
        disabled: List[int] = []
        for col, cid in enumerate(col_cluster):
            if cid not in live:
                disabled.append(col)
                continue
            pen = 0.0
            if home is not None and cid != home:
                pen += self.policy.remote_penalty
            if self.ledger.utilization(cid) \
                    >= self.policy.saturation_threshold:
                pen += self.policy.saturation_penalty
            if pen:
                penalties[col] = pen
        assignments = self._solve(cluster, batch, penalties, disabled)
        self.solves += 1
        if self.decisions is not None:
            self.decisions.append((cluster, batch, dict(penalties),
                                   list(disabled), assignments.copy()))
        out: List[Placement] = []
        for i, u in enumerate(units):
            col = int(assignments[i])
            cid = col_cluster[col] if 0 <= col < len(col_cluster) else None
            if cid is not None:
                self.ledger.note_admitted(cid, u.pods)
                self.placed_units += 1
            else:
                self.unplaced_units += 1
            out.append(Placement(unit=u, cluster=cid, home=home))
        return out

    # -- clusters as nodes, units as pods --------------------------------
    def _encode(self, clusters: List[int], units: List[PlacementUnit]):
        nodes = []
        for cid in clusters:
            milli, mem = self.ledger.remaining(cid)
            nodes.append(Node.from_dict({
                "metadata": {"name": f"cluster-{cid}", "labels": {
                    "kubernetes.io/hostname": f"cluster-{cid}"}},
                "status": {"capacity": {
                    "cpu": f"{max(milli, 0)}m",
                    "memory": str(max(mem, 0)),
                    # a cluster holds thousands of pods; 110 a node is a
                    # kubelet's cap, not a cluster's
                    "pods": "1000000"}},
            }))
        unit_pods = []
        for j, u in enumerate(units):
            pod = Pod.from_dict({
                "metadata": {"name": f"unit-{j}", "namespace": u.namespace},
                "spec": {"containers": [
                    {"name": "c", "image": "registry/fake:1",
                     "resources": {"requests": {"cpu": f"{u.milli}m",
                                                "memory": str(u.mem)}}}]},
            })
            pod.metadata.uid = f"fu-{j}"
            unit_pods.append(pod)
        enc = BatchEncoder(new_snapshot([], nodes))
        cluster, batch = enc.encode(unit_pods, pad_pods=self.policy.pad_pods)
        # column -> cluster by name, whatever order the encoder keeps
        by_name = {f"cluster-{cid}": cid for cid in clusters}
        col_cluster = [by_name.get(n) for n in cluster.node_names]
        return cluster, batch, col_cluster

    def _solve(self, cluster, batch, penalties: Dict[int, float],
               disabled: List[int]):
        if self.policy.serial:
            assignments, _ = _serial_whatif(
                cluster, batch, SolverParams(),
                deprioritized_cols=penalties, disabled_cols=disabled)
        else:
            assignments, _ = solve_whatif(
                cluster, batch, SolverParams(),
                deprioritized_cols=penalties, disabled_cols=disabled,
                device=self.device)
        return assignments
