"""The cluster autoscaler's control loop (the reference's
``core/static_autoscaler.go`` RunOnce), one pass a tick:

1. the trigger set: the scheduling queue's parked unschedulable pods
   (when a queue is attached) and the pods with a ``PodScheduled=False``
   Unschedulable condition;
2. when pods are pending and the scale-up cooldown has passed, one
   what-if solve per candidate node group (``simulator.plan_scale_up``,
   on the card unless ``device="cpu"``), the expander's choice, and the
   nodes it needs provisioned within the group's max size;
3. when nothing is pending, scale-down: a group node under the
   utilization threshold whose pods all fit elsewhere (the what-if with
   its column disabled) is, after ``scale_down_unneeded_time`` of being
   unneeded, cordoned and drained (evictions within the
   PodDisruptionBudgets' published ``disruptions_allowed``) and deleted
   once empty.

The loop runs on the controller scaffolding's tick thread;
``run_with_leader_election`` runs it only while this instance holds the
store's lease (one autoscaler a cluster: two would both provision), and
a lost lease stops the instance for good."""

from __future__ import annotations

import copy
import time
from typing import Dict, List, Optional

from kubernetes_tpu_torch.api.types import FAILED, SUCCEEDED, Node, Pod
from kubernetes_tpu_torch.autoscaler.nodegroups import (
    SAFE_TO_EVICT_ANNOTATION,
    NodeGroupRegistry,
    SimulatedProvisioner,
)
from kubernetes_tpu_torch.autoscaler.simulator import (
    plan_scale_up,
    pods_fit_elsewhere,
)
from kubernetes_tpu_torch.controllers.base import Controller, controller_of
from kubernetes_tpu_torch.device import resolve_device
from kubernetes_tpu_torch.metrics.autoscaler_metrics import (
    autoscaler_metrics,
)
from kubernetes_tpu_torch.scheduler.types import (
    compute_pod_resource_request,
    get_pod_key,
)


class ClusterAutoscaler(Controller):
    name = "clusterautoscaler"
    workers = 1
    RESYNC_SECONDS = 0.25           # the reference's --scan-interval, scaled

    expander = "least-waste"        # or "priority"
    scale_up_cooldown = 2.0         # least seconds between scale-up plans
    max_virtual_per_group = 64      # K, the virtual columns of a what-if
    max_whatif_pods = 2048          # pending pods a what-if places
    scale_down_enabled = True
    scale_down_utilization_threshold = 0.5   # max(cpu, mem) requested share
    scale_down_unneeded_time = 3.0  # the reference's --scale-down-unneeded-time
    max_concurrent_drains = 1
    pending_age_backstop = 3.0      # without a queue: a pending pod this old

    def __init__(self, store, factory,
                 registry: Optional[NodeGroupRegistry] = None,
                 provisioner: Optional[SimulatedProvisioner] = None,
                 device=None):
        self.registry = registry if registry is not None \
            else NodeGroupRegistry()
        self.provisioner = provisioner if provisioner is not None \
            else SimulatedProvisioner(store, self.registry)
        self.device = resolve_device(device)
        # the scheduler's queue, when the scheduler runs in this process:
        # its parked unschedulable pods are the trigger set
        self.queue_introspect = None
        self.metrics = autoscaler_metrics()
        self.whatif_solves = 0
        self.whatif_seconds = 0.0   # host seconds of the what-if calls
        self.scale_up_events = 0
        self.scale_down_events = 0
        self._last_scale_up = 0.0
        self._pending_first_seen: Optional[float] = None
        self._unneeded_since: Dict[str, float] = {}
        self._draining: Dict[str, str] = {}   # node name -> group name
        # evictions spent per PDB against the status generation seen:
        # [resource_version, used]; ``disruptions_allowed`` lags this
        # loop's deletions until the budget's status is recomputed
        self._pdb_spent: Dict[str, list] = {}
        self.elector = None
        super().__init__(store, factory)

    def register(self) -> None:
        # tick-driven: each pass reads the store
        pass

    def resync(self) -> None:
        self.enqueue_key("reconcile")

    def sync(self, key: str) -> None:
        self.reconcile_once()

    def run(self) -> None:
        self.provisioner.start()
        super().run()

    def stop(self) -> None:
        super().stop()
        self.provisioner.stop()
        if self.elector is not None:
            self.elector.stop()

    def run_with_leader_election(
            self, identity: str = "cluster-autoscaler-0",
            lease_name: str = "cluster-autoscaler",
            lease_duration: float = 15.0, renew_deadline: float = 10.0,
            retry_period: float = 2.0, clock=None):
        """Run the loop only while this instance holds the lease
        ``lease_name``; losing it stops the instance for good. Returns the
        ``LeaderElector``."""
        from kubernetes_tpu_torch.client.leaderelection import (
            LeaderElectionConfig,
            LeaderElector,
        )

        self.elector = LeaderElector(self.store, LeaderElectionConfig(
            lock_name=lease_name, identity=identity,
            lease_duration=lease_duration, renew_deadline=renew_deadline,
            retry_period=retry_period, on_started_leading=self.run,
            on_stopped_leading=self._on_lost_lease), clock=clock)
        self.elector.run_in_thread()
        return self.elector

    def _on_lost_lease(self) -> None:
        if not self._stopped:
            self.stop()

    def reconcile_once(self) -> None:
        if not len(self.registry):
            return
        now = time.monotonic()
        # one pod list a pass
        pods = self.store.list_pods()
        self._continue_drains(pods)
        pending = self.pending_unschedulable(pods)
        self.metrics.pending_unschedulable.set(float(len(pending)))
        if pending:
            if self._pending_first_seen is None:
                self._pending_first_seen = now
            if now - self._last_scale_up >= self.scale_up_cooldown:
                self._scale_up(pods, pending, now)
        else:
            if self._pending_first_seen is not None:
                self.metrics.time_to_capacity_seconds.observe(
                    now - self._pending_first_seen)
                self._pending_first_seen = None
            if self.scale_down_enabled:
                self._scale_down(pods, now)

    def pending_unschedulable(self, pods: Optional[List[Pod]] = None
                              ) -> List[Pod]:
        """The queue's parked pods and the pods with an Unschedulable
        condition; never a bound, terminal or deleting pod. Without a
        queue, a pending pod older than ``pending_age_backstop`` too."""
        out: Dict[str, Pod] = {}
        q = self.queue_introspect
        if q is not None:
            for pod in q.unschedulable_pods():
                if pod.spec.node_name or \
                        pod.metadata.deletion_timestamp is not None or \
                        pod.status.phase in (SUCCEEDED, FAILED):
                    continue
                out[get_pod_key(pod)] = pod
        now_wall = time.time()
        for pod in (pods if pods is not None else self.store.list_pods()):
            if pod.spec.node_name or \
                    pod.metadata.deletion_timestamp is not None or \
                    pod.status.phase in (SUCCEEDED, FAILED):
                continue
            key = get_pod_key(pod)
            if key in out:
                continue
            if any(c.type == "PodScheduled" and c.status == "False"
                   and c.reason == "Unschedulable"
                   for c in pod.status.conditions):
                out[key] = pod
            elif q is None and pod.metadata.creation_timestamp and \
                    now_wall - pod.metadata.creation_timestamp \
                    >= self.pending_age_backstop:
                out[key] = pod
        return list(out.values())

    @staticmethod
    def _live_bound_pods(pods: List[Pod]) -> List[Pod]:
        return [p for p in pods
                if p.spec.node_name and p.status.phase not in (SUCCEEDED,
                                                                FAILED)
                and p.metadata.deletion_timestamp is None]

    def _scale_up(self, pods: List[Pod], pending: List[Pod],
                  now: float) -> None:
        groups = []
        for group in self.registry:
            headroom = group.max_size - self.provisioner.group_size(
                group.name)
            if headroom > 0:
                groups.append((group, headroom))
        if not groups:
            return
        # upcoming before the node list: a node registering between the
        # reads shows twice (harmless), never in neither (a re-buy)
        upcoming = self.provisioner.booting_templates()
        bound = self._live_bound_pods(pods)
        t0 = time.monotonic()
        plan = plan_scale_up(
            self.store.list_nodes(), bound, pending, groups,
            expander=self.expander, upcoming=upcoming,
            max_virtual=self.max_virtual_per_group,
            max_pods=self.max_whatif_pods, device=self.device)
        self.whatif_seconds += time.monotonic() - t0
        self.whatif_solves += plan.solves
        # the cooldown paces plans, not only purchases: a pod no group
        # helps would otherwise cost a solve a group every tick
        self._last_scale_up = now
        best = plan.chosen
        if best is None or best.nodes_needed <= 0:
            return
        self.provisioner.provision(self.registry.get(best.group),
                                   best.nodes_needed)
        self.scale_up_events += 1
        self.metrics.scaleups_total.inc(best.group, self.expander,
                                        amount=best.nodes_needed)

    @staticmethod
    def _drainable(pod: Pod) -> bool:
        """A pod something recreates, or one that opts in."""
        if controller_of(pod) is not None:
            return True
        return pod.metadata.annotations.get(SAFE_TO_EVICT_ANNOTATION) \
            == "true"

    @staticmethod
    def _utilization(node: Node, pods: List[Pod]) -> float:
        alloc = node.status.allocatable
        cpu_alloc = int(alloc["cpu"].milli_value()) if "cpu" in alloc else 0
        mem_alloc = int(alloc["memory"].value()) if "memory" in alloc else 0
        cpu_used = mem_used = 0
        for p in pods:
            r = compute_pod_resource_request(p)
            cpu_used += r.milli_cpu
            mem_used += r.memory
        fracs = []
        if cpu_alloc:
            fracs.append(cpu_used / cpu_alloc)
        if mem_alloc:
            fracs.append(mem_used / mem_alloc)
        return max(fracs) if fracs else 0.0

    def _scale_down(self, pods: List[Pod], now: float) -> None:
        nodes = self.store.list_nodes()
        bound = self._live_bound_pods(pods)
        pods_by_node: Dict[str, List[Pod]] = {}
        for p in bound:
            pods_by_node.setdefault(p.spec.node_name, []).append(p)
        sizes = {g.name: self.provisioner.group_size(g.name)
                 for g in self.registry}
        draining_per_group: Dict[str, int] = {}
        for g in self._draining.values():
            draining_per_group[g] = draining_per_group.get(g, 0) + 1
        live_names = set()
        for node in sorted(nodes, key=lambda n: n.name):
            name = node.name
            live_names.add(name)
            if name in self._draining:
                continue
            gname = NodeGroupRegistry.group_of(node)
            group = self.registry.get(gname) if gname else None
            if group is None:
                self._unneeded_since.pop(name, None)
                continue
            budget = sizes[gname] - group.min_size \
                - draining_per_group.get(gname, 0)
            its_pods = pods_by_node.get(name, [])
            unneeded = (
                budget > 0
                and not node.spec.unschedulable
                and self._utilization(node, its_pods)
                < self.scale_down_utilization_threshold
                and all(self._drainable(p) for p in its_pods))
            if not unneeded:
                self._unneeded_since.pop(name, None)
                continue
            since = self._unneeded_since.setdefault(name, now)
            if now - since < self.scale_down_unneeded_time:
                continue
            if len(self._draining) >= self.max_concurrent_drains:
                continue
            if its_pods:
                # the solve last, once the timer has matured
                self.whatif_solves += 1
                t0 = time.monotonic()
                fits = pods_fit_elsewhere(nodes, bound, name, its_pods,
                                          device=self.device)
                self.whatif_seconds += time.monotonic() - t0
                if not fits:
                    self._unneeded_since.pop(name, None)
                    continue
            self._cordon(name)
            self._draining[name] = gname
            draining_per_group[gname] = draining_per_group.get(gname, 0) + 1
            self._unneeded_since.pop(name, None)
        for name in list(self._unneeded_since):
            if name not in live_names:
                del self._unneeded_since[name]

    def _cordon(self, name: str, on: bool = True) -> None:
        node = self.store.get_node(name)
        if node is None:
            return
        node = copy.copy(node)
        node.metadata = copy.copy(node.metadata)
        node.spec = copy.copy(node.spec)
        node.spec.unschedulable = on
        self.store.update_node(node)

    def _uncordon(self, name: str) -> None:
        self._cordon(name, on=False)

    def _continue_drains(self, pods: List[Pod]) -> None:
        """Advance each drain: evict what the budgets allow; delete the
        node once it is empty. A blocked eviction waits for a later
        pass."""
        if not self._draining:
            return
        by_node: Dict[str, List[Pod]] = {}
        for p in pods:
            if p.spec.node_name and p.metadata.deletion_timestamp is None \
                    and p.status.phase not in (SUCCEEDED, FAILED):
                by_node.setdefault(p.spec.node_name, []).append(p)
        for name in sorted(self._draining):
            gname = self._draining[name]
            if self.store.get_node(name) is None:
                self._draining.pop(name)
                continue
            its_pods = by_node.get(name, [])
            if not its_pods:
                self.provisioner.deprovision(name)
                self._draining.pop(name)
                self.scale_down_events += 1
                self.metrics.scaledowns_total.inc(gname)
                continue
            if not all(self._drainable(p) for p in its_pods):
                # a pod nothing recreates landed before the cordon was
                # seen: the node is needed after all
                self._uncordon(name)
                self._draining.pop(name)
                continue
            for pod in its_pods:
                if not self._pdb_allows(pod):
                    continue
                self.store.delete_pod(pod.namespace, pod.metadata.name)
                self.metrics.evicted_for_scaledown_total.inc()

    def _pdb_allows(self, pod: Pod) -> bool:
        """The eviction API against the budgets' published status: every
        PDB matching the pod has budget left, and an eviction spends one
        of each (remembered against the status's resource version)."""
        matching = [pdb for pdb in self.store.list_pdbs()
                    if pdb.namespace == pod.namespace
                    and pdb.selector.matches(pod.metadata.labels)]

        def spent(pdb) -> int:
            ent = self._pdb_spent.get(f"{pdb.namespace}/{pdb.name}")
            if ent is not None and ent[0] == pdb.metadata.resource_version:
                return ent[1]
            return 0

        for pdb in matching:
            if pdb.status.disruptions_allowed - spent(pdb) <= 0:
                return False
        for pdb in matching:
            key = f"{pdb.namespace}/{pdb.name}"
            rv = pdb.metadata.resource_version
            ent = self._pdb_spent.get(key)
            if ent is not None and ent[0] == rv:
                ent[1] += 1
            else:
                self._pdb_spent[key] = [rv, 1]
        return True
