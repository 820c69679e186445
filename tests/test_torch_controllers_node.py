"""The node lifecycle controller and the pod garbage collector against
the JAX package's: the same store events and the same fake clock drive
both packages' controllers, which must leave the same taints, Ready
conditions, evictions and deletions, with the same health timestamps,
the re-registered node's fresh grace included; and the store's
``lease_info`` reads what the JAX store's does."""

import time

import pytest

from kubernetes_tpu.apiserver.store import ClusterStore as JaxStore
from kubernetes_tpu.client.informers import (
    SharedInformerFactory as JaxFactory,
)
from kubernetes_tpu.controllers.nodelifecycle import (
    NodeLifecycleController as JaxNLC,
)
from kubernetes_tpu.controllers.podgc import PodGCController as JaxGC
from kubernetes_tpu.metrics.fabric_metrics import (
    fabric_metrics as jax_fabric_metrics,
)
from kubernetes_tpu.testing import MakeNode as JaxNode, MakePod as JaxPod
from kubernetes_tpu.utils.clock import FakeClock as JaxClock
from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.client.informers import SharedInformerFactory
from kubernetes_tpu_torch.controllers.nodelifecycle import (
    UNREACHABLE_TAINT,
    NodeLifecycleController,
)
from kubernetes_tpu_torch.controllers.podgc import PodGCController
from kubernetes_tpu_torch.metrics.fabric_metrics import fabric_metrics
from kubernetes_tpu_torch.testing import MakeNode, MakePod
from kubernetes_tpu_torch.utils.clock import FakeClock

PACKAGES = {
    "jax": (JaxStore, JaxFactory, JaxNLC, JaxGC, JaxNode, JaxPod, JaxClock,
            jax_fabric_metrics),
    "port": (ClusterStore, SharedInformerFactory, NodeLifecycleController,
             PodGCController, MakeNode, MakePod, FakeClock, fabric_metrics),
}


class Side:
    """One package's store, informer factory and controllers."""

    def __init__(self, pkg):
        (store_t, factory_t, nlc_t, gc_t, self.make_node, self.make_pod,
         clock_t, self.metrics) = PACKAGES[pkg]
        self.store = store_t()
        self.clock = clock_t(start=100.0)
        self.factory = factory_t(self.store)
        self.nlc = nlc_t(self.store, self.factory, clock=self.clock)
        self.gc = gc_t(self.store, self.factory)
        self.factory.start()
        assert self.factory.wait_for_cache_sync()

    def node(self, name):
        self.store.add_node(self.make_node().name(name).capacity(
            {"cpu": "8", "memory": "16Gi"}).obj())

    def pod(self, name, node=None, tolerate=False):
        w = self.make_pod().name(name).uid(f"u-{name}").req({"cpu": "100m"})
        if tolerate:
            w = w.toleration(UNREACHABLE_TAINT, operator="Exists")
        self.store.create_pod(w.obj())
        if node:
            self.store.bind("default", name, f"u-{name}", node)

    def synced(self, timeout=5.0):
        """Wait until the informers' caches hold the store's versions."""
        def versions(objs):
            return {o.metadata.name: o.metadata.resource_version
                    for o in objs}

        deadline = time.time() + timeout
        while time.time() < deadline:
            if (versions(self.nlc.node_lister.list())
                    == versions(self.store.list_nodes())
                    and versions(self.nlc.pod_lister.list())
                    == versions(self.store.list_pods())):
                return
            time.sleep(0.01)
        raise AssertionError("informers did not catch up with the store")

    def monitor(self):
        self.synced()
        self.nlc.monitor_node_health()
        self.synced()

    def state(self):
        nodes = {}
        for n in sorted(self.store.list_nodes(), key=lambda n: n.name):
            ready = [(c.status, c.reason, c.message)
                     for c in n.status.conditions if c.type == "Ready"]
            nodes[n.name] = {
                "taints": sorted((t.key, t.effect) for t in n.spec.taints),
                "ready": ready,
            }
        return {"nodes": nodes,
                "pods": sorted((p.name, p.spec.node_name)
                               for p in self.store.list_pods()),
                "not_ready_since": dict(self.nlc._not_ready_since),
                "first_seen": dict(self.nlc._first_seen),
                "lease": {n: self.store.lease_info(f"node-{n}")
                          for n in ("n1", "n2", "n3")}}

    def stop(self):
        self.factory.stop()


def _run_lifecycle(pkg):
    side = Side(pkg)
    trail = []
    try:
        for name in ("n1", "n2", "n3"):
            side.node(name)
        side.pod("p1", "n1")
        side.pod("p2", "n2")
        side.pod("p3", "n1", tolerate=True)   # tolerates unreachable
        side.pod("p4", "n3")
        side.nlc.heartbeat("n2")
        side.monitor()
        trail.append(side.state())
        side.clock.step(30.0)
        side.nlc.heartbeat("n2")
        side.monitor()                          # all inside the grace
        trail.append(side.state())
        side.clock.step(15.0)
        side.monitor()                          # n1, n3 past the grace
        trail.append(side.state())
        side.clock.step(5.0)
        side.monitor()                          # not yet the eviction grace
        trail.append(side.state())
        side.clock.step(6.0)
        side.monitor()                          # evicts p1 and p4, not p3
        trail.append(side.state())
        side.nlc.heartbeat("n1")
        side.monitor()                          # n1 ready again
        trail.append(side.state())
        # n3 deleted and registered again: a fresh grace, not the old
        # incarnation's not-ready time
        side.store.delete_node("n3")
        deadline = time.time() + 5
        while time.time() < deadline and "n3" in side.nlc._not_ready_since:
            time.sleep(0.01)
        side.node("n3")
        side.monitor()
        trail.append(side.state())
        side.clock.step(side.nlc.grace_period / 2)
        side.nlc.heartbeat("n1")
        side.nlc.heartbeat("n2")
        side.monitor()
        trail.append(side.state())
        side.clock.step(side.nlc.grace_period)
        side.nlc.heartbeat("n1")
        side.nlc.heartbeat("n2")
        side.monitor()                          # n3 silent past its grace
        trail.append(side.state())
    finally:
        side.stop()
    return trail


def test_lifecycle_matches_the_reference():
    jax, port = _run_lifecycle("jax"), _run_lifecycle("port")
    assert port == jax
    # the run did what it meant to: tainted, evicted, healed, re-graced
    assert port[2]["nodes"]["n1"]["taints"] == [(UNREACHABLE_TAINT,
                                                 "NoExecute")]
    assert ("p1", "n1") in port[3]["pods"]
    assert [p for p, _ in port[4]["pods"]] == ["p2", "p3"]
    assert port[5]["nodes"]["n1"]["taints"] == []
    assert port[5]["nodes"]["n1"]["ready"] == [("True", "KubeletReady", "")]
    assert port[6]["nodes"]["n3"]["taints"] == []
    assert port[6]["first_seen"]["n3"] == 156.0
    assert port[7]["nodes"]["n3"]["taints"] == []
    assert port[8]["nodes"]["n3"]["taints"] == [(UNREACHABLE_TAINT,
                                                 "NoExecute")]


def test_lease_info_matches_the_reference():
    out = {}
    for pkg in PACKAGES:
        store = PACKAGES[pkg][0]()
        got = [store.lease_info("node-a")]
        store.try_acquire_or_renew("node-a", "a", 5.0, 40.0)
        got.append(store.lease_info("node-a"))
        store.try_acquire_or_renew("node-a", "a", 7.5, 40.0)
        got.append(store.lease_info("node-a"))
        assert store.try_acquire_or_renew("node-a", "b", 8.0, 40.0) is False
        got.append(store.lease_info("node-a"))
        out[pkg] = got
    assert out["port"] == out["jax"] == [None, ("a", 5.0), ("a", 7.5),
                                         ("a", 7.5)]


def _orphaned_total(metrics):
    return sum(v for _, labels, v in metrics().node_evictions_total.collect()
               if "orphaned" in labels)


def _run_podgc(pkg, threshold):
    side = Side(pkg)
    try:
        side.node("live")
        side.gc.terminated_threshold = threshold
        for i, phase in enumerate(("Succeeded", "Failed", "Succeeded",
                                   "Failed", "Succeeded")):
            pod = side.make_pod().name(f"t{i}").uid(f"ut{i}") \
                .phase(phase).obj()
            pod.metadata.creation_timestamp = 50.0 - i   # t4 is the oldest
            side.store.create_pod(pod)
        side.pod("running", "live")
        side.pod("orphan-a", "ghost")
        side.pod("orphan-b", "gone")
        side.store.create_pod(side.make_pod().name("dying").uid("ud")
                              .terminating(3.0).obj())
        side.store.create_pod(side.make_pod().name("pending").uid("up")
                              .obj())
        before = _orphaned_total(side.metrics)
        side.gc.sync("podgc")
        return (sorted(p.name for p in side.store.list_pods()),
                _orphaned_total(side.metrics) - before)
    finally:
        side.stop()


@pytest.mark.parametrize("threshold", [0, 2, 12500])
def test_podgc_matches_the_reference(threshold):
    jax, port = _run_podgc("jax", threshold), _run_podgc("port", threshold)
    assert port == jax
    names, orphaned = port
    assert orphaned == 2
    assert "orphan-a" not in names and "dying" not in names
    assert {"running", "pending"} <= set(names)
    terminated = [n for n in names if n.startswith("t")]
    assert len(terminated) == min(5, threshold)
    if threshold == 2:
        assert terminated == ["t0", "t1"]   # the oldest went first


def test_podgc_collects_orphans_of_a_deleted_node_on_its_own():
    """The node's delete enqueues a sync: the worker collects the
    orphans without a tick."""
    side = Side("port")
    try:
        side.gc.RESYNC_SECONDS = None
        side.gc.run()
        side.node("doomed")
        side.pod("a", "doomed")
        side.synced()
        side.store.delete_node("doomed")
        deadline = time.time() + 5
        while time.time() < deadline and side.store.list_pods():
            time.sleep(0.02)
        assert side.store.list_pods() == []
    finally:
        side.gc.stop()
        side.stop()
