"""The node-churn harness (``harness/chaos_nodes.py``) against the JAX
package's: the churn profiles, the seeded injector's action sequence
and its effect on the store, the void-bind tripwire and the rescuer over
the same events, a node deleted and registered again converging in the
scheduler's cache, and seeded cells with the batch path on the CPU, with
and without the autoscaler (the churn runs on the wall clock, so the
cells are held to their invariants, not to the JAX cells' placements)."""

import dataclasses
import time
from types import SimpleNamespace

import pytest

from kubernetes_tpu.apiserver.store import ClusterStore as JaxStore
from kubernetes_tpu.harness import chaos_nodes as jax_nodes
from kubernetes_tpu.testing import MakeNode as JaxNode, MakePod as JaxPod
from kubernetes_tpu_torch.apiserver.rest import APIServer
from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.client.restcluster import RestClusterClient
from kubernetes_tpu_torch.harness import chaos_nodes
from kubernetes_tpu_torch.testing import MakeNode, MakePod

SIDES = {"jax": (JaxStore, JaxNode, JaxPod, jax_nodes),
         "port": (ClusterStore, MakeNode, MakePod, chaos_nodes)}

# the invariant names of the JAX harness's verdict
INVARIANTS = {"all_bound_or_terminal", "taints_healed",
              "no_binds_to_dead_nodes", "no_oversubscription",
              "cache_converged"}


def test_churn_profiles_match_the_reference():
    assert list(chaos_nodes.CHURN_PROFILES) == list(jax_nodes.CHURN_PROFILES)
    for name, spec in chaos_nodes.CHURN_PROFILES.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(
            jax_nodes.CHURN_PROFILES[name]), name
    assert chaos_nodes.CHAOS_TAINT == jax_nodes.CHAOS_TAINT
    assert chaos_nodes.VoidBindWatch.GRACE_S == \
        jax_nodes.VoidBindWatch.GRACE_S == 0.25


def _injector_trail(pkg, profile, seed):
    store_t, make_node, _, mod = SIDES[pkg]
    store = store_t()
    names = [f"cn{i}" for i in range(8)]
    for name in names:
        store.add_node(make_node().name(name).capacity(
            {"cpu": "16", "memory": "64Gi"}).obj())
    beats = []
    pump = mod.HeartbeatPump(SimpleNamespace(heartbeat=beats.append),
                             names, interval=1.0)
    inj = mod.NodeChurnInjector(store, pump, mod.CHURN_PROFILES[profile],
                                names, seed, grace_period=1.0)
    trail = []
    now = 1000.0
    for _ in range(60):
        now += 0.3
        inj._heal_due(now)
        inj._unmute_due(now)
        inj._act(now)
        trail.append((
            sorted((n.name, bool(n.spec.unschedulable),
                    sorted(t.key for t in n.spec.taints))
                   for n in store.list_nodes()),
            sorted(pump._muted), dict(inj.actions)))
    inj.restore_all()
    pump.beat_now()
    trail.append((sorted((n.name, bool(n.spec.unschedulable),
                          sorted(t.key for t in n.spec.taints))
                         for n in store.list_nodes()),
                  sorted(pump._muted), dict(inj.actions), sorted(beats)))
    return trail


@pytest.mark.parametrize("profile,seed", [("mixed", 3), ("killer", 17),
                                          ("flappy", 29), ("gentle", 3)])
def test_injector_replays_the_reference_sequence(profile, seed):
    jax = _injector_trail("jax", profile, seed)
    port = _injector_trail("port", profile, seed)
    assert port == jax
    actions = port[-1][2]
    assert actions["kill"] + actions["flap"] > 0
    # healed: every node back, none cordoned, no chaos taint, none muted
    nodes, muted = port[-1][0], port[-1][1]
    assert len(nodes) == 8 and not muted
    assert all(not cordoned and chaos_nodes.CHAOS_TAINT not in taints
               for _, cordoned, taints in nodes)


def _void_binds(pkg):
    store_t, make_node, make_pod, mod = SIDES[pkg]
    store = store_t()
    watch = mod.VoidBindWatch(store, name_prefix="cp-")
    watch.start()
    try:
        store.add_node(make_node().name("n1").obj())
        for i in range(4):
            store.create_pod(make_pod().name(f"cp-{i}").uid(f"u{i}").obj())
        store.create_pod(make_pod().name("other").uid("uo").obj())
        store.delete_node("n1")
        store.bind("default", "cp-0", "u0", "n1")   # inside the grace
        time.sleep(mod.VoidBindWatch.GRACE_S + 0.1)
        store.bind("default", "cp-1", "u1", "n1")   # into the void
        store.bind("default", "other", "uo", "n1")  # not a workload pod
        store.add_node(make_node().name("n1").obj())
        store.bind("default", "cp-2", "u2", "n1")   # the node is back
        return [v.split(" ")[0] for v in watch.violations]
    finally:
        watch.stop()


def test_void_bind_watch_matches_the_reference(monkeypatch):
    # a grace wide enough that a loaded machine cannot push the bind made
    # right after the delete past it
    for mod in (chaos_nodes, jax_nodes):
        monkeypatch.setattr(mod.VoidBindWatch, "GRACE_S", 1.0)
    assert _void_binds("port") == _void_binds("jax") == ["cp-1"]


def test_evicted_pod_is_recreated_and_rescue_latency_observed():
    store = ClusterStore()
    store.add_node(MakeNode().name("n1")
                   .capacity({"cpu": "8", "memory": "16Gi"}).obj())
    server = APIServer(store=store).start()
    client = RestClusterClient(server.url, watch_kinds=())
    rescuer = chaos_nodes.PodRescuer(store, client, name_prefix="cp-")
    rescuer.start()
    try:
        store.create_pod(MakePod().name("cp-0").uid("u0")
                         .req({"cpu": "100m"}).obj())
        store.bind("default", "cp-0", "u0", "n1")
        store.delete_pod("default", "cp-0")      # the eviction
        deadline = time.time() + 10
        while time.time() < deadline:
            pod = store.get_pod("default", "cp-0")
            if pod is not None and pod.uid == "u0-r1":
                break
            time.sleep(0.02)
        pod = store.get_pod("default", "cp-0")
        assert pod is not None and pod.uid == "u0-r1"
        assert pod.spec.node_name == ""          # enters scheduling again
        assert rescuer.pending() == 1
        store.bind("default", "cp-0", "u0-r1", "n1")
        deadline = time.time() + 10
        while time.time() < deadline and rescuer.pending():
            time.sleep(0.02)
        assert rescuer.pending() == 0
        assert len(rescuer.rescues) == 1 and rescuer.rescues[0] >= 0
        assert rescuer.evictions_seen == 1 and rescuer.recreate_failures == 0
    finally:
        rescuer.stop()
        client.close()
        server.shutdown_server()


def test_recreated_node_gets_a_fresh_grace_and_the_cache_converges():
    """A node deleted and created again under its name mid-workload: the
    lifecycle controller's purge hands the new incarnation a full grace
    (no inherited not-ready time, no instant eviction), and the
    scheduler's cache converges to exactly one live node."""
    from kubernetes_tpu_torch.client.informers import SharedInformerFactory
    from kubernetes_tpu_torch.config.feature_gates import FeatureGates
    from kubernetes_tpu_torch.controllers.nodelifecycle import (
        UNREACHABLE_TAINT,
        NodeLifecycleController,
    )
    from kubernetes_tpu_torch.scheduler.scheduler import Scheduler
    from kubernetes_tpu_torch.utils.clock import FakeClock

    def tainted():
        return any(t.key == UNREACHABLE_TAINT
                   for t in store.get_node("n1").spec.taints)

    store = ClusterStore()
    clock = FakeClock(start=100.0)
    store.add_node(MakeNode().name("n1")
                   .capacity({"cpu": "8", "memory": "16Gi"}).obj())
    factory = SharedInformerFactory(store)
    nlc = NodeLifecycleController(store, factory, clock=clock)
    factory.start()
    assert factory.wait_for_cache_sync()
    sched = Scheduler.create(store, feature_gates=FeatureGates(
        {"TPUBatchScheduler": False}))
    sched.start()
    try:
        store.create_pod(MakePod().name("p").uid("u")
                         .req({"cpu": "100m"}).obj())
        store.bind("default", "p", "u", "n1")
        nlc.heartbeat("n1")
        nlc.monitor_node_health()
        clock.step(45.0)
        nlc.monitor_node_health()
        assert tainted()
        store.delete_node("n1")
        deadline = time.time() + 5
        while time.time() < deadline and "n1" in nlc._not_ready_since:
            time.sleep(0.02)
        assert "n1" not in nlc._not_ready_since
        assert "n1" not in nlc._first_seen
        store.add_node(MakeNode().name("n1")
                       .capacity({"cpu": "8", "memory": "16Gi"}).obj())
        deadline = time.time() + 5
        while time.time() < deadline and not any(
                n.name == "n1" for n in nlc.node_lister.list()):
            time.sleep(0.02)
        nlc.monitor_node_health()
        assert not tainted()
        clock.step(nlc.grace_period / 2)
        nlc.monitor_node_health()
        assert not tainted()
        clock.step(nlc.grace_period)
        nlc.monitor_node_health()
        assert tainted()
        deadline = time.time() + 5
        while time.time() < deadline and sched.cache.node_count() != 1:
            time.sleep(0.02)
        dump = sched.cache.dump()
        assert [n for n, info in dump["nodes"].items()
                if info.node is not None] == ["n1"]
    finally:
        sched.stop()
        factory.stop()


@pytest.mark.parametrize("autoscale", [False, True],
                         ids=["mixed", "killer+autoscale"])
def test_seeded_cell_holds_every_invariant_on_the_cpu(autoscale):
    """Seed 3 mixed at the JAX defaults, and the JAX package's
    churn-with-autoscaler case (seed 29, killer, 10 nodes of 4 cpu, 70
    pods: the workload needs about 9 nodes, so the autoscaler must buy
    replacements)."""
    if autoscale:
        res = chaos_nodes.run_chaos_nodes(
            29, nodes=10, pods=70, node_cpu=4, waves=4,
            churn_profile="killer", autoscale=True, wait_timeout=120.0,
            device="cpu")
    else:
        res = chaos_nodes.run_chaos_nodes(3, wait_timeout=120.0,
                                          device="cpu")
    assert res["ok"], res
    assert set(res["invariants"]) == INVARIANTS
    st = res["stats"]
    assert st["device"] == "cpu" and st["batch_solves"] > 0
    assert st["churn_actions"]["kill"] + st["churn_actions"]["flap"] > 0
    assert st["recreate_failures"] == 0
    if autoscale:
        assert st["autoscaler_nodes_added"] >= 1 and st["whatif_solves"] >= 1
    else:
        assert st["whatif_solves"] == 0
