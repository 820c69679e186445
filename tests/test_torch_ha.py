"""The scheduler's HA modes against the JAX package's, in process:

- leader election on a fake clock (lease expiry follows the clock; the
  elector's waits are real): only the holder schedules, a leader stopped
  or deposed never schedules again, the standby takes over; the same
  scenario gives the same leaders and the same per-scheduler bind counts
  in both packages (the JAX package's ``tests/test_scheduler.py``
  leader-election case, on a fake clock); a leader whose lease a standby
  has taken binds nothing, though its renew deadline has not run out
  (the port's own rule). The cluster autoscaler runs only while it holds
  its own lease;
- the replica set's shard functions equal the reference's on 10,000
  seeded names; a two-replica set with pods created before start binds
  each pod to the same node as the JAX replica set over its in-process
  store (node pools and shared nodes);
- ``SchedulerCache.commit_fits`` gives the reference's verdicts on seeded
  batches; a sibling's binds landing between a replica's solve and its
  commit are refused by the capacity guard, counted, and placed again
  by the serial path, with no node over its allocatable;
- the cache debugger finds the drift the reference's
  ``tests/test_debugger.py`` finds.

Tolerance: exact equality."""

import copy
import time
import zlib

import numpy as np
import pytest
import torch

from kubernetes_tpu.api.types import Node as JaxNode, Pod as JaxPod
from kubernetes_tpu.apiserver.store import ClusterStore as JaxStore
from kubernetes_tpu.config.types import (
    KubeSchedulerConfiguration as JaxConfig,
)
from kubernetes_tpu.scheduler.cache import SchedulerCache as JaxCache
from kubernetes_tpu.scheduler.debugger import CacheDebugger as JaxDebugger
from kubernetes_tpu.scheduler.replicas import (
    SchedulerReplicaSet as JaxReplicaSet,
    node_shard_fn as jax_node_shard_fn,
    pod_shard_fn as jax_pod_shard_fn,
)
from kubernetes_tpu.scheduler.scheduler import Scheduler as JaxScheduler
from kubernetes_tpu.utils.clock import FakeClock as JaxFakeClock
from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.autoscaler.controller import ClusterAutoscaler
from kubernetes_tpu_torch.client.informers import SharedInformerFactory
from kubernetes_tpu_torch.config.feature_gates import FeatureGates
from kubernetes_tpu_torch.config.types import KubeSchedulerConfiguration
from kubernetes_tpu_torch.harness import ha
from kubernetes_tpu_torch.scheduler.cache import SchedulerCache
from kubernetes_tpu_torch.scheduler.debugger import CacheDebugger
from kubernetes_tpu_torch.scheduler.replicas import (
    SchedulerReplicaSet,
    node_shard_fn,
    pod_shard_fn,
)
from kubernetes_tpu_torch.scheduler.scheduler import Scheduler
from kubernetes_tpu_torch.sidecar import attach_batch_scheduler
from kubernetes_tpu_torch.utils.clock import FakeClock


def wait_for(cond, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def node_dict(i, cpu="8", pods="110"):
    return {"metadata": {"name": f"n{i}",
                         "labels": {"kubernetes.io/hostname": f"n{i}"}},
            "status": {"capacity": {"cpu": cpu, "memory": "16Gi",
                                    "pods": pods}}}


def pod_dict(name, cpu="100m"):
    return {"metadata": {"name": name, "uid": f"u-{name}"},
            "spec": {"containers": [{"name": "c", "resources": {
                "requests": {"cpu": cpu, "memory": "64Mi"}}}]}}


class Side:
    """One package's types, so a scenario runs on either."""

    def __init__(self, ref):
        self.ref = ref
        self.Store = JaxStore if ref else ClusterStore
        self.Node = JaxNode if ref else Node
        self.Pod = JaxPod if ref else Pod
        self.Clock = JaxFakeClock if ref else FakeClock

    def store(self, nodes=(), pods=()):
        store = self.Store()
        for d in nodes:
            store.add_node(self.Node.from_dict(copy.deepcopy(d)))
        for d in pods:
            self.create(store, d)
        return store

    def create(self, store, d):
        pod = self.Pod.from_dict(copy.deepcopy(d))
        if self.ref:
            store.create_pod(pod)
        else:
            store.create_pods([pod])

    def scheduler(self, store):
        cfg = (JaxConfig if self.ref else KubeSchedulerConfiguration)(
            parallelism=1)
        return (JaxScheduler if self.ref else Scheduler).create(
            store, config=cfg)

    @staticmethod
    def scheduled(sched):
        return int(sched.metrics.schedule_attempts.get(
            "scheduled", "default-scheduler"))


# ----------------------------------------------------------------------
# leader election
def election_scenario(side: Side):
    """A leads, B stands by; 8 pods; A stops; the clock passes the lease;
    B leads; 8 pods; an intruder takes the lease from B; the clock passes
    B's renew deadline; B is deposed for good. Returns the log of what
    was seen."""
    store = side.store([node_dict(0, cpu="64")])
    clock = side.Clock(100.0)
    a, b = side.scheduler(store), side.scheduler(store)
    kw = dict(clock=clock, lease_duration=15.0, renew_deadline=10.0,
              retry_period=0.02)
    log = []
    ea = a.run_with_leader_election(identity="sched-a", **kw)
    assert wait_for(lambda: ea.is_leader)
    eb = b.run_with_leader_election(identity="sched-b", **kw)
    time.sleep(0.2)
    log.append(("leaders", ea.is_leader, eb.is_leader,
                store.lease_holder("kube-scheduler")))

    def wave(prefix):
        for i in range(8):
            side.create(store, pod_dict(f"{prefix}{i}"))
        assert wait_for(lambda: all(p.spec.node_name
                                    for p in store.list_pods()))
        log.append((prefix, side.scheduled(a), side.scheduled(b)))

    wave("w1-")
    a.stop()
    time.sleep(0.1)
    log.append(("after stop", eb.is_leader))
    clock.step(16.0)
    assert wait_for(lambda: eb.is_leader)
    log.append(("leaders", ea.is_leader, eb.is_leader,
                store.lease_holder("kube-scheduler")))
    wave("w2-")
    # an intruder holds the lease: B's renewals fail until its deadline
    store.try_acquire_or_renew("kube-scheduler", "intruder",
                               clock.now() + 16.0, 15.0)
    clock.step(16.0)
    for _ in range(100):
        # past each renew deadline B may have set since
        if not eb.is_leader and b.lost_lease:
            break
        time.sleep(0.05)
        clock.step(11.0)
    assert not eb.is_leader and b.lost_lease
    for i in range(4):
        side.create(store, pod_dict(f"w3-{i}"))
    time.sleep(0.3)
    log.append(("deposed", b.lost_lease, a.lost_lease,
                sum(1 for p in store.list_pods() if not p.spec.node_name),
                side.scheduled(a), side.scheduled(b)))
    a.stop()
    b.stop()
    return log


def test_leader_election_on_a_fake_clock_like_the_reference():
    got = election_scenario(Side(ref=False))
    want = election_scenario(Side(ref=True))
    assert got == want
    assert got == [
        ("leaders", True, False, "sched-a"),
        ("w1-", 8, 0),
        ("after stop", False),
        ("leaders", False, True, "sched-b"),
        ("w2-", 8, 8),
        ("deposed", True, False, 4, 8, 8)]


@pytest.mark.parametrize("path", ("serial", "batch"))
def test_a_leader_binds_nothing_once_a_standby_holds_its_lease(path):
    """B takes the lease while A's renew deadline has not run out (the
    fake clock stands still): A still counts itself leader and drains its
    queue, but binds nothing, on the serial path and the batch path's
    bulk commit alike; its refusals are counted under "lease" and go back
    to its backoff, and B, elected, binds every pod on its own."""
    store = ClusterStore()
    store.add_node(Node.from_dict(node_dict(0, cpu="64")))
    clock = FakeClock(100.0)
    kw = dict(clock=clock, lease_duration=15.0, renew_deadline=10.0,
              retry_period=0.02)
    gates = FeatureGates({"TPUBatchScheduler": path == "batch"})
    a, b = (Scheduler.create(store, config=KubeSchedulerConfiguration(
        parallelism=1), feature_gates=gates) for _ in range(2))
    for sched in (a, b):
        bs = attach_batch_scheduler(sched, max_batch=64, device="cpu",
                                    pipeline=False)
        assert (bs is not None) == (path == "batch")
    ea = a.run_with_leader_election(identity="sched-a", **kw)
    try:
        assert wait_for(lambda: ea.is_leader)
        # B's lease, renewed as of a time past A's: A's renewals fail
        assert store.try_acquire_or_renew("kube-scheduler", "sched-b",
                                          clock.now() + 16.0, 15.0)
        store.create_pods([Pod.from_dict(pod_dict(f"p{i}"))
                           for i in range(8)])
        assert wait_for(lambda: a.stale_binds_rejected.get("lease", 0) >= 8)
        time.sleep(0.2)
        assert ea.is_leader and not a.lost_lease
        assert store.count_bound() == 0
        eb = b.run_with_leader_election(identity="sched-b", **kw)
        assert wait_for(lambda: eb.is_leader)
        assert wait_for(lambda: store.count_bound() == 8)
        assert Side.scheduled(a) == 0 and Side.scheduled(b) == 8
    finally:
        a.stop()
        b.stop()


def test_store_leases_like_the_reference():
    rng = np.random.default_rng(3)
    stores = (ClusterStore(), JaxStore())
    for _ in range(300):
        name = f"l{int(rng.integers(3))}"
        holder = f"h{int(rng.integers(4))}"
        now = float(rng.integers(0, 100))
        dur = float(rng.choice([5.0, 15.0]))
        got = [s.try_acquire_or_renew(name, holder, now, dur)
               for s in stores]
        assert got[0] == got[1]
        assert stores[0].lease_holder(name) == stores[1].lease_holder(name)


def test_autoscaler_runs_only_while_leading():
    store = ClusterStore()
    clock = FakeClock()
    cas = [ClusterAutoscaler(store, SharedInformerFactory(store),
                             device="cpu") for _ in range(2)]
    ran = []
    for i, ca in enumerate(cas):
        ca.run = (lambda i=i: ran.append(i))
    e0 = cas[0].run_with_leader_election(identity="ca-0", clock=clock,
                                         retry_period=0.02)
    assert wait_for(lambda: e0.is_leader)
    e1 = cas[1].run_with_leader_election(identity="ca-1", clock=clock,
                                         retry_period=0.02)
    time.sleep(0.2)
    assert ran == [0] and not e1.is_leader
    cas[0].stop()
    clock.step(16.0)
    assert wait_for(lambda: e1.is_leader)
    assert ran == [0, 1]
    assert store.lease_holder("cluster-autoscaler") == "ca-1"
    cas[1].stop()


# ----------------------------------------------------------------------
# replica sets
def test_shard_functions_equal_the_reference():
    rng = np.random.default_rng(11)
    names = [f"ns{int(rng.integers(50))}/pod-{int(rng.integers(1 << 30))}"
             for _ in range(10000)]
    pods, jpods = [], []
    for i, n in enumerate(names):
        for cls, out in ((Pod, pods), (JaxPod, jpods)):
            pod = cls.from_dict({"metadata": {
                "name": n.split("/")[1], "namespace": n.split("/")[0]}})
            # every third pod without a uid: keyed by namespace/name
            pod.metadata.uid = n if i % 3 else ""
            out.append(pod)
    for count in (2, 3, 5):
        for index in range(count):
            own, jown = pod_shard_fn(index, count), jax_pod_shard_fn(index,
                                                                      count)
            assert [own(p) for p in pods] == [jown(p) for p in jpods]
            nown = node_shard_fn(index, count)
            jnown = jax_node_shard_fn(index, count)
            assert [nown(n) for n in names] == [jnown(n) for n in names]
    assert sum(pod_shard_fn(0, 2)(p) for p in pods) not in (0, len(pods))


def _drive(pairs, timeout=30.0):
    """Run each replica's batch loop in turn until no pod is due an
    attempt and nothing is held."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        progressed = 0
        for sched, bs in pairs:
            sched.queue.flush_backoff_completed()
            progressed += bs.run_batch(pop_timeout=0.0)
        if not progressed and all(
                s.queue.pending_active_count() == 0 for s, _ in pairs):
            break
    for sched, bs in pairs:
        bs.flush()
        sched.wait_for_inflight_bindings()


@pytest.mark.parametrize("shard_nodes", (True, False))
def test_two_replicas_bind_like_the_reference(shard_nodes):
    nodes = [node_dict(i) for i in range(24)]
    pods = [pod_dict(f"p{i}", cpu=str(["250m", "500m", "1"][i % 3]))
            for i in range(90)]
    placements = []
    for ref in (False, True):
        side = Side(ref)
        store = side.store(nodes, pods)
        if ref:
            rs = JaxReplicaSet(lambda i: store, count=2,
                               shard_nodes=shard_nodes, use_batch=True,
                               max_batch=64)
        else:
            rs = SchedulerReplicaSet(lambda i: store, count=2,
                                     shard_nodes=shard_nodes, use_batch=True,
                                     max_batch=64, device="cpu",
                                     pipeline=False)
        for sched in rs.replicas:
            sched.start()
        try:
            _drive(list(zip(rs.replicas, rs.batch_schedulers)))
        finally:
            rs.stop()
        placements.append({p.metadata.name: p.spec.node_name
                           for p in store.list_pods()})
        if not ref:
            counts = rs.bound_counts()
    got, want = placements
    assert got == want
    assert all(got.values()) and sum(counts) == len(pods)
    assert all(c > 0 for c in counts)
    if shard_nodes:
        for name, node in got.items():
            owner = zlib.crc32(f"u-{name}".encode()) % 2
            assert node_shard_fn(owner, 2)(node), (name, node)


def test_replica_set_runs_on_threads():
    """Two replicas on their own loops (``run``), pods created after the
    start: every pod bound once, on its own replica's pool."""
    store = ClusterStore()
    for i in range(40):
        store.add_node(Node.from_dict(node_dict(i)))
    rs = SchedulerReplicaSet(lambda i: store, count=2, shard_nodes=True,
                             use_batch=True, max_batch=64, device="cpu")
    binds = []
    store.watch(lambda evs: binds.extend(
        e.obj.metadata.name for e in evs
        if e.kind == "Pod" and e.obj.spec.node_name
        and e.old_obj is not None and not e.old_obj.spec.node_name))
    rs.run()
    try:
        store.create_pods([Pod.from_dict(pod_dict(f"q{i}"))
                           for i in range(300)])
        assert wait_for(lambda: store.count_bound() == 300, 60.0)
    finally:
        rs.stop()
    assert len(binds) == len(set(binds)) == 300
    assert sum(rs.bound_counts()) == 300
    for p in store.list_pods():
        owner = zlib.crc32(p.uid.encode()) % 2
        assert node_shard_fn(owner, 2)(p.spec.node_name)


def test_commit_fits_verdicts_equal_the_reference():
    rng = np.random.default_rng(5)
    for trial in range(6):
        caches = (SchedulerCache(), JaxCache())
        nodes = [node_dict(i, cpu=str(int(rng.choice([1, 2, 4]))),
                           pods=str(int(rng.choice([3, 110]))))
                 for i in range(8)]
        for cache, (NodeT, PodT) in zip(caches, ((Node, Pod),
                                                 (JaxNode, JaxPod))):
            for d in nodes:
                cache.add_node(NodeT.from_dict(copy.deepcopy(d)))
        bound = [dict(pod_dict(f"b{trial}-{i}",
                               cpu=str(int(rng.choice([250, 500]))) + "m"),
                      ) for i in range(12)]
        for d in bound:
            d["spec"]["nodeName"] = f"n{int(rng.integers(8))}"
        for cache, PodT in zip(caches, (Pod, JaxPod)):
            for d in bound:
                cache.add_pod(PodT.from_dict(copy.deepcopy(d)))
        batch = [(pod_dict(f"c{trial}-{i}", cpu=str(int(rng.choice(
            [100, 500, 1000]))) + "m"), f"n{int(rng.integers(9))}")
            for i in range(40)]
        got = caches[0].commit_fits([(Pod.from_dict(copy.deepcopy(d)), n)
                                     for d, n in batch])
        want = caches[1].commit_fits([(JaxPod.from_dict(copy.deepcopy(d)),
                                       n) for d, n in batch])
        assert got == want
        assert "capacity" in got and None in got


def test_capacity_guard_refuses_a_siblings_node():
    """Replica B solves; before it commits, replica A's binds fill most
    nodes (a watch batch into B's cache): B's commit probe refuses those
    placements, counts them, and B's serial path places the pods where
    room is left. No node ends over its allocatable."""
    store = ClusterStore()
    for i in range(6):
        store.add_node(Node.from_dict(node_dict(i, cpu="2")))
    rs = SchedulerReplicaSet(lambda i: store, count=2,
                             shard_nodes=False, use_batch=True,
                             max_batch=64, device="cpu", pipeline=False)
    a, b = rs.replicas
    assert a.commit_capacity_guard and b.commit_capacity_guard
    bs_b = rs.batch_schedulers[1]
    rs.start()
    pods = [pod_dict(f"g{i}", cpu="500m") for i in range(16)]
    mine = [d for d in pods if b.pod_shard(Pod.from_dict(d))]
    fillers = [pod_dict(f"f{i}", cpu="1500m") for i in range(4)]
    store.create_pods([Pod.from_dict(d) for d in fillers])   # A's
    real_solve = bs_b.session.solve

    def solve_then_sibling_binds(*args, **kw):
        out = real_solve(*args, **kw)
        if fillers:
            for i, d in enumerate(fillers):
                store.bind("default", d["metadata"]["name"],
                           d["metadata"]["uid"], f"n{i}")
            fillers.clear()
        return out

    bs_b.session.solve = solve_then_sibling_binds
    store.create_pods([Pod.from_dict(d) for d in mine])
    _drive([(b, bs_b)])
    rs.stop()
    assert bs_b.capacity_routed > 0
    assert b.stale_binds_rejected.get("capacity", 0) >= bs_b.capacity_routed
    used = {}
    for p in store.list_pods():
        assert p.spec.node_name, p.metadata.name
        req = p.spec.containers[0].resources.requests["cpu"].milli_value()
        used[p.spec.node_name] = used.get(p.spec.node_name, 0) + req
    assert max(used.values()) <= 2000


# ----------------------------------------------------------------------
# the cache debugger
def debugger_scenario(side: Side):
    store = side.store([node_dict(1)])
    sched = side.scheduler(store)
    sched.run()
    try:
        side.create(store, pod_dict("p1", cpu="500m"))
        assert wait_for(lambda: store.get_pod("default", "p1").spec.node_name)
        dbg = (JaxDebugger if side.ref else CacheDebugger)(
            store, sched.cache, sched.queue)
        assert wait_for(lambda: dbg.compare().consistent)
        dump = dbg.dump()
        for info in dump["nodes"].values():
            info.pop("generation")
        dbg.dump_to_log()
        store._nodes["ghost"] = side.Node.from_dict(
            {"metadata": {"name": "ghost"}})
        drift = vars(dbg.compare())
        return dump, drift, dbg.compare().consistent
    finally:
        sched.stop()


def test_debugger_finds_the_references_drift():
    got = debugger_scenario(Side(ref=False))
    want = debugger_scenario(Side(ref=True))
    assert got == want
    dump, drift, consistent = got
    assert dump["nodes"]["n1"]["pods"] == ["default/p1"]
    assert dump["nodes"]["n1"]["requested_milli_cpu"] == 500
    assert drift["missing_nodes"] == ["ghost"] and not consistent


def test_debugger_signal_handler_installs():
    import signal
    store = ClusterStore()
    sched = Scheduler(store)
    dbg = CacheDebugger(store, sched.cache, sched.queue)
    old = signal.getsignal(signal.SIGUSR2)
    try:
        assert dbg.listen_for_signal()
        assert signal.getsignal(signal.SIGUSR2) is not old
    finally:
        signal.signal(signal.SIGUSR2, old)


# ----------------------------------------------------------------------
# chip_smoke phase 30's rows, at a small size on the CPU
def test_config_row_on_the_cpu():
    row = ha.config_row(nodes=200, pods=800, every=40, device="cpu",
                        max_batch=128)
    res = row.pop("result")
    assert res.solves > 0 and all(res.placements.values())
    for key in ("unbound", "extender_violations", "packing_violations",
                "packing_unscored", "rescore_mismatches", "not_serial"):
        assert row[key] == [], key
    assert row["serial_pods"] == row["extender_pods"] + row["packing_pods"]
    assert row["extender_calls"]["filter"] == row["extender_pods"]


@pytest.mark.parametrize("shard_nodes,node_pods,pipeline", (
    (True, "110", None), (False, "6", True), (False, "5", False)))
def test_replica_row_on_the_cpu(shard_nodes, node_pods, pipeline):
    """Node pools; shared nodes filled (700 pods, 720 slots); shared
    nodes over-filled (600 slots): every slot taken, none twice."""
    row = ha.replica_row(nodes=120, pods=700, shard_nodes=shard_nodes,
                         device="cpu", max_batch=128, node_pods=node_pods,
                         pipeline=pipeline)
    for key in ("lost", "double_binds", "pool_violations",
                "over_allocatable"):
        assert row[key] == [], key
    bound = sum(row["bound_by_replica"])
    assert bound + row["unschedulable"] == 700
    assert bound == min(700, 120 * int(node_pods))
    assert all(n > 0 for n in row["solves_by_replica"])


def test_failover_row_on_the_cpu():
    row = ha.failover_row(nodes=120, pods=1200, stop_after=400,
                          device="cpu", max_batch=128)
    assert row["lost"] == [] and row["double_binds"] == []
    assert row["leader_bound_after_stop"] == 0
    assert row["standby_bound_before_stop"] == 0
    assert row["leader_bound"] + row["standby_bound"] == 1200
    assert row["binds_after_stop"] == row["standby_bound"] > 0
    assert row["standby_leads"] and row["standby_solves"] > 0
    assert row["failover_gap_s"] >= 2.0 - 0.25   # the lease must lapse


def test_ha_rows_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for row in (lambda: ha.config_row(nodes=4, pods=8, every=4),
                lambda: ha.replica_row(nodes=4, pods=8),
                lambda: ha.failover_row(nodes=4, pods=8, stop_after=2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            row()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SchedulerReplicaSet(lambda i: ClusterStore(), use_batch=True)
