"""The configuration and HA rows: SchedulingBasic driven through a
scheduler built from a v1beta1 dict, through a replica set, and through
an elected pair that fails over. Each runs on ``device`` (the card unless
"cpu"; no card raises) and returns a dict of its numbers and of the
violations its checks found (empty lists when all hold):

- ``config_row``: ``Scheduler.create`` from a dict with ``parallelism``
  16, the adaptive ``percentageOfNodesToScore``, two profiles
  (``default-scheduler``, and ``packing``, which scores with
  NodeResourcesMostAllocated in NodeResourcesLeastAllocated's place) and
  one HTTP extender on loopback (``harness.extender``) managing
  ``EXT_RESOURCE``, which every node advertises. Every ``every``-th pod
  requests it (the extender's pods: serial), every ``every``-th from
  ``every // 2`` runs under ``packing`` (serial), the rest batch. Checks:
  every pod bound, every extender and packing pod through the serial
  path, every extender pod on a node the extender passed, every packing
  pod on a node of the highest total score of its attempt,
  and MostAllocated's score of every scored node equal to a plain
  re-score from the node's requests;
- ``replica_row``: ``SchedulerReplicaSet(count, shard_nodes,
  use_batch=True)`` over one store (pods sharded by hash), each replica
  on its own loop thread and batch path. Checks: every pod bound, none
  twice, each on its replica's pool (node pools), no node over its
  allocatable (shared nodes, where the capacity guard arbitrates);
- ``failover_row``: two schedulers, each with its batch path, each under
  ``run_with_leader_election`` on the store's lease; the leader is
  stopped once ``stop_after`` pods are bound. Checks: every pod bound,
  none twice, nothing bound by the stopped leader after its stop, the
  rest by the standby on its own session.

Latencies are enqueue-to-bind (ms, the scheduler's
``pending_latencies``); pods/s runs from the pods' creation to the last
bind.
"""

from __future__ import annotations

import time
import zlib
from typing import Dict, List

from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.config.feature_gates import FeatureGates
from kubernetes_tpu_torch.device import resolve_device
from kubernetes_tpu_torch.harness import perf, workloads
from kubernetes_tpu_torch.harness.extender import LoopbackExtender, crc_keeps
from kubernetes_tpu_torch.scheduler.replicas import (
    SchedulerReplicaSet,
    node_shard_fn,
)
from kubernetes_tpu_torch.scheduler.scheduler import Scheduler
from kubernetes_tpu_torch.scheduler.types import compute_pod_resource_request
from kubernetes_tpu_torch.sidecar import attach_batch_scheduler
from kubernetes_tpu_torch.utils.gctune import tune_for_throughput

EXT_RESOURCE = "example.com/ext"
PACKING = "packing"
ROW_TIMEOUT_S = 600.0
# the failover row's lease: its duration, renew deadline and retry period
LEASE = dict(lease_duration=2.0, renew_deadline=1.5, retry_period=0.25)


def config_dict(extender_url: str, parallelism: int = 16) -> dict:
    """The v1beta1 configuration of the config row."""
    return {
        "parallelism": parallelism,
        "percentageOfNodesToScore": 0,
        "profiles": [
            {"schedulerName": "default-scheduler"},
            {"schedulerName": PACKING, "plugins": {"score": {
                "disabled": [{"name": "NodeResourcesLeastAllocated"}],
                "enabled": [{"name": "NodeResourcesMostAllocated",
                             "weight": 1}]}}}],
        "extenders": [{"urlPrefix": extender_url, "filterVerb": "filter",
                       "prioritizeVerb": "prioritize", "weight": 1,
                       "managedResources": [{"name": EXT_RESOURCE}]}],
    }


def _config_ops(nodes: int, pods: int, every: int) -> List[dict]:
    """SchedulingBasic with ``EXT_RESOURCE`` on every node, and the
    extender's and the packing profile's pods among the measured ones."""
    def node(i):
        d = workloads.node_template(i)
        d["status"]["capacity"][EXT_RESOURCE] = "1000"
        return d

    def pod(i):
        d = workloads.basic_pod(i)
        if i % every == 0:
            d["spec"]["containers"][0]["resources"]["requests"][
                EXT_RESOURCE] = "1"
        elif i % every == every // 2:
            d["spec"]["schedulerName"] = PACKING
        return d

    return [{"opcode": "createNodes", "count": nodes, "nodeTemplate": node},
            {"opcode": "createPods", "count": pods, "podTemplate": pod,
             "collectMetrics": True, "offset": 0,
             "skipWaitToCompletion": False}]


def most_allocated_plain(node_info, pod: Pod) -> int:
    """NodeResourcesMostAllocated's score, plainly: the used share of cpu
    and memory with the pod (non-zero requests), each in [0, 100],
    averaged."""
    req = compute_pod_resource_request(pod, non_zero=True)
    total = n = 0
    for used, alloc in (
            (node_info.non_zero_requested.milli_cpu + req.milli_cpu,
             node_info.allocatable.milli_cpu),
            (node_info.non_zero_requested.memory + req.memory,
             node_info.allocatable.memory)):
        if alloc:
            total += min(used, alloc) * 100 // alloc
            n += 1
    return total // n if n else 0


class _PackingAudit:
    """Wraps the packing profile's Score: per pod, the nodes of the
    highest total, and every MostAllocated score held against
    ``most_allocated_plain``."""

    def __init__(self, sched: Scheduler):
        self.best: Dict[str, set] = {}
        self.rescore_mismatches: List[tuple] = []
        self.scored = 0
        fwk = sched.profiles[PACKING]
        real = fwk.run_score_plugins

        def audited(state, pod, node_names):
            scores, status = real(state, pod, node_names)
            if status is None:
                snap = sched.snapshot
                totals = {n: 0 for n in node_names}
                for per_node in scores.values():
                    for ns in per_node:
                        totals[ns.name] += ns.score
                top = max(totals.values())
                self.best[pod.name] = {n for n, t in totals.items()
                                       if t == top}
                for ns in scores["NodeResourcesMostAllocated"]:
                    want = most_allocated_plain(snap.get(ns.name), pod)
                    if ns.score != want:
                        self.rescore_mismatches.append(
                            (pod.name, ns.name, ns.score, want))
                self.scored += len(node_names)
            return scores, status

        fwk.run_score_plugins = audited


def config_row(nodes: int = 5000, pods: int = 30000, every: int = 200,
               device=None, max_batch: int = 4096,
               parallelism: int = 16) -> dict:
    """The config row (see the module's docstring); ``parallelism`` sets
    the serial path's Filter and Score workers
    (``tools/serial_parallelism.py`` compares 16 with 1)."""
    ext = LoopbackExtender().start()
    serial: List[str] = []
    audit: List[_PackingAudit] = []

    def setup(bs):
        sched = bs.sched
        real = sched.schedule_pod_serial

        def counted(qpi):
            serial.append(qpi.pod.name)
            return real(qpi)

        sched.schedule_pod_serial = counted
        audit.append(_PackingAudit(sched))

    try:
        res = perf.run_workload(
            "SchedulingBasic", _config_ops(nodes, pods, every),
            max_batch=max_batch, device=device,
            config=config_dict(ext.url, parallelism), configure=setup)
    finally:
        ext.stop()
    placements = res.placements
    ext_pods = [f"pod-{i}" for i in range(0, pods, every)]
    packing = [f"pod-{i}" for i in range(every // 2, pods, every)]
    pa = audit[0]
    return {
        "result": res,
        "extender_calls": dict(ext.calls),
        "serial_pods": len(set(serial)),
        "serial_attempts": len(serial),
        "serial_seconds": res.host_paths["serial"],
        "extender_pods": len(ext_pods), "packing_pods": len(packing),
        "packing_nodes_scored": pa.scored,
        "unbound": [n for n, v in placements.items() if not v],
        "extender_violations": [n for n in ext_pods
                                if not crc_keeps(placements[n] or "")],
        "packing_violations": [
            n for n in packing
            if n in pa.best and placements[n] not in pa.best[n]],
        "packing_unscored": [n for n in packing if n not in pa.best],
        "not_serial": [n for n in ext_pods + packing
                       if n not in set(serial)],
        "rescore_mismatches": pa.rescore_mismatches[:10],
    }


def _bind_watch(store: ClusterStore):
    """(bind transitions by pod name, each as [count, first time]; the
    watch handle)."""
    binds: Dict[str, list] = {}

    def on_events(events):
        now = time.monotonic()
        for e in events:
            if (e.kind == "Pod" and e.obj.spec.node_name
                    and e.old_obj is not None
                    and not e.old_obj.spec.node_name):
                rec = binds.setdefault(e.obj.metadata.name, [0, now])
                rec[0] += 1

    return binds, store.watch(on_events)


def _wait_bound(store: ClusterStore, n: int, timeout: float) -> float:
    deadline = time.monotonic() + timeout
    while store.count_bound() < n:
        if time.monotonic() > deadline:
            raise TimeoutError(f"{store.count_bound()} of {n} pods bound "
                               f"in {timeout} s")
        time.sleep(0.002)
    return time.monotonic()


def _wait_settled(store: ClusterStore, scheds, pods: int,
                  timeout: float) -> float:
    """Until every pod is bound, or no scheduler has a pod due an attempt
    or a batch held for a second on end (the rest wait unschedulable)."""
    deadline = time.monotonic() + timeout
    quiet_since = None
    while True:
        now = time.monotonic()
        if store.count_bound() >= pods:
            return now
        if all(s.queue.pending_active_count() == 0 and not (
                s.batch_scheduler is not None
                and s.batch_scheduler.holding) for s in scheds):
            quiet_since = quiet_since or now
            if now - quiet_since > 1.0:
                return quiet_since
        else:
            quiet_since = None
        if now > deadline:
            raise TimeoutError(f"{store.count_bound()} of {pods} pods "
                               f"bound in {timeout} s")
        time.sleep(0.002)


def _over_allocatable(store: ClusterStore) -> List[str]:
    """Nodes whose bound pods' requests pass their allocatable cpu,
    memory or pod count."""
    used: Dict[str, list] = {}
    for p in store.list_pods():
        if p.spec.node_name:
            req = compute_pod_resource_request(p)
            u = used.setdefault(p.spec.node_name, [0, 0, 0])
            u[0] += req.milli_cpu
            u[1] += req.memory
            u[2] += 1
    over = []
    for node in store.list_nodes():
        u = used.get(node.name, [0, 0, 0])
        alloc = node.status.allocatable
        if (u[0] > alloc["cpu"].milli_value()
                or u[1] > alloc["memory"].value()
                or u[2] > alloc["pods"].value()):
            over.append(node.name)
    return over


def _latency_ms(scheds) -> dict:
    samples = [s for sched in scheds for s in sched.pending_latencies]
    return {"Perc50": perf.sample_percentile(samples, 0.50) * 1000.0,
            "Perc99": perf.sample_percentile(samples, 0.99) * 1000.0,
            "samples": len(samples)}


def _warm(bs, n: int = 200) -> None:
    bs.warmup([Pod.from_dict(workloads.basic_pod(10 ** 7 + i))
               for i in range(n)])


def replica_row(nodes: int = 5000, pods: int = 30000, count: int = 2,
                shard_nodes: bool = True, device=None,
                max_batch: int = 4096, node_pods: str = "110",
                pipeline=None) -> dict:
    """The replica row (see the module's docstring); ``pipeline`` picks
    the batch loops' arm (default: the environment's)."""
    dev = resolve_device(device)
    tune_for_throughput()
    store = ClusterStore()
    for i in range(nodes):
        d = workloads.node_template(i)
        d["status"]["capacity"]["pods"] = node_pods
        store.add_node(Node.from_dict(d))
    rs = SchedulerReplicaSet(lambda i: store, count=count,
                             shard_nodes=shard_nodes, use_batch=True,
                             max_batch=max_batch, device=dev,
                             pipeline=pipeline)
    binds, watch = _bind_watch(store)
    rs.start()
    for bs in rs.batch_schedulers:
        _warm(bs)
    rs.run()
    try:
        t0 = time.monotonic()
        store.create_pods([Pod.from_dict(workloads.basic_pod(i))
                           for i in range(pods)])
        t1 = _wait_settled(store, rs.replicas, pods, ROW_TIMEOUT_S)
    finally:
        rs.stop()
        watch.stop()
    placed = {p.metadata.name: (p.uid, p.spec.node_name)
              for p in store.list_pods()}
    pool_violations = []
    if shard_nodes:
        for name, (uid, node) in placed.items():
            owner = zlib.crc32(uid.encode()) % count
            if node and not node_shard_fn(owner, count)(node):
                pool_violations.append(name)
    unbound = [n for n, (_, node) in placed.items() if not node]
    unschedulable = [p.metadata.name for p in store.list_pods()
                     if not p.spec.node_name and any(
                         c.type == "PodScheduled" and c.status == "False"
                         for c in p.status.conditions)]
    return {
        "device": str(dev), "pods": pods, "nodes": nodes,
        "pipeline": rs.batch_schedulers[0].pipeline_enabled,
        "seconds": t1 - t0, "pods_per_s": pods / (t1 - t0),
        "latency_ms": _latency_ms(rs.replicas),
        "bound_by_replica": rs.bound_counts(),
        "discards_by_replica": [bs.discards for bs in rs.batch_schedulers],
        "solves_by_replica": [bs.session.backend.solves
                              for bs in rs.batch_schedulers],
        "capacity_rejects": sum(s.stale_binds_rejected.get("capacity", 0)
                                for s in rs.replicas),
        "capacity_routed": sum(bs.capacity_routed
                               for bs in rs.batch_schedulers),
        "lost": [n for n in unbound if n not in unschedulable],
        "unschedulable": len(unschedulable),
        "double_binds": [n for n, (k, _) in binds.items() if k > 1],
        "pool_violations": pool_violations,
        "over_allocatable": _over_allocatable(store),
    }


def failover_row(nodes: int = 5000, pods: int = 30000,
                 stop_after: int = 10000, device=None,
                 max_batch: int = 4096) -> dict:
    """The failover row (see the module's docstring)."""
    dev = resolve_device(device)
    tune_for_throughput()
    store = ClusterStore()
    for i in range(nodes):
        store.add_node(Node.from_dict(workloads.node_template(i)))
    gates = FeatureGates({"TPUBatchScheduler": True})
    pair = []
    for _ in range(2):
        sched = Scheduler.create(store, provider="GangSchedulingProvider",
                                 feature_gates=gates)
        bs = attach_batch_scheduler(sched, max_batch=max_batch, device=dev)
        sched.start()
        _warm(bs)
        pair.append((sched, bs))
    (a, bs_a), (b, bs_b) = pair
    binds, watch = _bind_watch(store)
    ea = a.run_with_leader_election(identity="scheduler-a", **LEASE)
    deadline = time.monotonic() + 30.0
    while not ea.is_leader and time.monotonic() < deadline:
        time.sleep(0.01)
    eb = b.run_with_leader_election(identity="scheduler-b", **LEASE)
    try:
        t0 = time.monotonic()
        store.create_pods([Pod.from_dict(workloads.basic_pod(i))
                           for i in range(pods)])
        _wait_bound(store, stop_after, ROW_TIMEOUT_S)
        t_stop = time.monotonic()
        a.stop()
        t_stopped = time.monotonic()
        a_at_stop = _scheduled(a)
        b_at_stop = _scheduled(b)
        t1 = _wait_bound(store, pods, ROW_TIMEOUT_S)
        standby_leads = eb.is_leader
    finally:
        a.stop()
        b.stop()
        watch.stop()
    after = sorted(t for _, t in binds.values() if t >= t_stopped)
    return {
        "device": str(dev), "pods": pods, "nodes": nodes,
        "seconds": t1 - t0, "pods_per_s": pods / (t1 - t0),
        "latency_ms": _latency_ms((a, b)),
        "bound_before_stop": store_bound_at(binds, t_stop),
        "leader_bound": a_at_stop, "leader_bound_after_stop":
            _scheduled(a) - a_at_stop,
        "standby_bound_before_stop": b_at_stop,
        "standby_bound": _scheduled(b),
        "binds_after_stop": len(after),
        "stop_seconds": t_stopped - t_stop,
        "failover_gap_s": (after[0] - t_stop) if after else None,
        "standby_solves": bs_b.session.backend.solves,
        "leader_solves": bs_a.session.backend.solves,
        "standby_leads": standby_leads, "leader_lost_lease": a.lost_lease,
        "lost": [p.metadata.name for p in store.list_pods()
                 if not p.spec.node_name],
        "double_binds": [n for n, (k, _) in binds.items() if k > 1],
    }


def _scheduled(sched: Scheduler) -> int:
    return int(sum(sched.metrics.schedule_attempts.get("scheduled", name)
                   for name in sched.profiles))


def store_bound_at(binds: Dict[str, list], t: float) -> int:
    """Pods first bound before ``t``."""
    return sum(1 for _, first in binds.values() if first < t)

