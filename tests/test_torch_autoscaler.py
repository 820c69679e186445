"""The port's cluster autoscaler against the JAX package's, on the CPU:
node templates; ``plan_scale_up`` under both expanders with upcoming
(booting) nodes and a headroom cap; ``pods_fit_elsewhere`` with the
candidate's column disabled; the port's batched plan against its own
per-pod serial oracle; one ``reconcile_once`` scale-up and a PDB-bound
drain with a ``SimulatedProvisioner`` of zero boot latency; and the
workqueue and informers it rides on. Inputs are manifest dicts made from
a seed and read by both packages. A host-port pod pending among the
others keeps its what-if row, unplaced, in both packages. Tolerance:
exact equality (the waste share is the same float arithmetic on the
same integers)."""

import copy
import random
import time

import numpy as np
import pytest

from kubernetes_tpu.api.types import Node as JaxNode, Pod as JaxPod
from kubernetes_tpu.api.types import PodCondition as JaxPodCondition
from kubernetes_tpu.api.types import Taint as JaxTaint
from kubernetes_tpu.apiserver.store import ClusterStore as JaxStore
from kubernetes_tpu.autoscaler import controller as jax_controller
from kubernetes_tpu.autoscaler import nodegroups as jax_nodegroups
from kubernetes_tpu.autoscaler import simulator as jax_simulator
from kubernetes_tpu.client.informers import (
    SharedInformerFactory as JaxFactory,
)
from kubernetes_tpu_torch.api.labels import LabelSelector
from kubernetes_tpu_torch.api.types import (
    Node,
    ObjectMeta,
    Pod,
    PodCondition,
    PodDisruptionBudget,
    PodDisruptionBudgetStatus,
    Taint,
)
from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.autoscaler import simulator
from kubernetes_tpu_torch.autoscaler.controller import ClusterAutoscaler
from kubernetes_tpu_torch.autoscaler.nodegroups import (
    NODE_GROUP_LABEL,
    SAFE_TO_EVICT_ANNOTATION,
    NodeGroup,
    NodeGroupRegistry,
    SimulatedProvisioner,
)
from kubernetes_tpu_torch.client.informers import SharedInformerFactory
from kubernetes_tpu_torch.client.workqueue import RateLimitingQueue, WorkQueue

ZONE = "topology.kubernetes.io/zone"
PORT = {"node": Node.from_dict, "pod": Pod.from_dict, "group": NodeGroup,
        "taint": Taint, "sim": simulator}
JAX = {"node": JaxNode.from_dict, "pod": JaxPod.from_dict,
       "group": jax_nodegroups.NodeGroup, "taint": JaxTaint,
       "sim": jax_simulator}


def node_dict(name, cpu, zone, used=None):
    return {"metadata": {"name": name, "labels": {
        "kubernetes.io/hostname": name, ZONE: zone}},
        "status": {"capacity": {"cpu": str(cpu), "memory": "16Gi",
                                "pods": "20"}}}


def pod_dict(name, cpu_milli, node="", zone=None, priority=None):
    spec = {"containers": [{"name": "c", "resources": {"requests": {
        "cpu": f"{cpu_milli}m", "memory": "256Mi"}}}]}
    if node:
        spec["nodeName"] = node
    if zone is not None:
        spec["nodeSelector"] = {ZONE: zone}
    if priority is not None:
        spec["priority"] = priority
    return {"metadata": {"name": name, "uid": f"u-{name}",
                         "labels": {"app": "x"}}, "spec": spec}


def world(seed):
    """Node, bound-pod and pending-pod dicts, and group specs, of a
    seeded cluster filled to 60-100% with a burst past it."""
    rng = random.Random(seed)
    nodes, bound = [], []
    for i in range(rng.randint(6, 10)):
        cpu = rng.choice([2, 4, 8])
        nodes.append(node_dict(f"rn{i}", cpu, f"z{i % 2}"))
        bound.append(pod_dict(f"rf{i}", int(cpu * 1000 * rng.uniform(
            0.6, 1.0)), node=f"rn{i}"))
    pending = [pod_dict(f"rp{i}", rng.choice([500, 1000, 2000]),
                        zone=(f"z{rng.randint(0, 1)}"
                              if rng.random() < 0.3 else None),
                        priority=rng.choice([None, 0, 5]))
               for i in range(rng.randint(30, 60))]
    groups = [dict(name=f"rg{j}", cpu=str(cpu), memory="16Gi",
                   labels={ZONE: f"z{j % 2}"}, priority=rng.randint(0, 5),
                   headroom=rng.choice([2, 16]))
              for j, cpu in enumerate(rng.sample([2, 4, 8, 16], k=3))]
    return nodes, bound, pending, groups


def build(pkg, nodes, bound, pending, groups):
    mk = lambda key, ds: [pkg[key](copy.deepcopy(d)) for d in ds]  # noqa
    gs = []
    for g in groups:
        g = dict(g)
        headroom = g.pop("headroom")
        gs.append((pkg["group"](**g, taints=[pkg["taint"](
            "team", "ml", "PreferNoSchedule")]), headroom))
    return mk("node", nodes), mk("pod", bound), mk("pod", pending), gs


def options(plan):
    return ([(o.group, o.nodes_needed, o.pods_placed, o.pods_on_new,
              o.waste) for o in plan.options],
            plan.chosen and plan.chosen.group, plan.solves)


def test_node_template_equals_the_reference():
    spec = dict(name="ng", cpu="8", memory="32Gi", max_pods=50,
                labels={ZONE: "z1"})
    a = NodeGroup(**spec, taints=[Taint("k", "v", "NoSchedule")])
    b = jax_nodegroups.NodeGroup(**spec, taints=[JaxTaint("k", "v",
                                                          "NoSchedule")])
    x, y = a.node_template(3), b.node_template(3)
    assert x.name == y.name == "ng-3"
    assert x.metadata.labels == y.metadata.labels
    assert x.metadata.labels[NODE_GROUP_LABEL] == "ng"
    assert {k: q.milli_value() for k, q in x.status.allocatable.items()} \
        == {k: q.milli_value() for k, q in y.status.allocatable.items()}
    assert [(t.key, t.value, t.effect) for t in x.spec.taints] == \
        [(t.key, t.value, t.effect) for t in y.spec.taints]


@pytest.mark.parametrize("seed", (7, 21, 42, 1337))
@pytest.mark.parametrize("expander", ("least-waste", "priority"))
@pytest.mark.parametrize("upcoming", (0, 3))
def test_plan_scale_up_equals_the_reference(seed, expander, upcoming):
    nodes, bound, pending, groups = world(seed)
    plans = []
    for pkg in (PORT, JAX):
        n, b, p, gs = build(pkg, nodes, bound, pending, groups)
        booting = [gs[0][0].node_template(100 + i) for i in range(upcoming)]
        kw = {"device": "cpu"} if pkg is PORT else {}
        plans.append(pkg["sim"].plan_scale_up(
            n, b, p, gs, expander=expander, upcoming=booting,
            max_virtual=12, max_pods=20, **kw))
    assert options(plans[0]) == options(plans[1])
    assert plans[0].solves == 3 and plans[0].chosen is not None


@pytest.mark.parametrize("seed", (7, 21, 42, 1337))
def test_batched_equals_the_serial_oracle(seed):
    nodes, bound, pending, groups = world(seed)
    n, b, p, gs = build(PORT, nodes, bound, pending, groups)
    for expander in ("least-waste", "priority"):
        batched = simulator.plan_scale_up(n, b, p, gs, expander=expander,
                                          device="cpu")
        serial = simulator.plan_scale_up(n, b, p, gs, expander=expander,
                                         serial=True)
        assert options(batched) == options(serial)
        assert batched.chosen is not None


@pytest.mark.parametrize("fill", ("free", "full"))
def test_pods_fit_elsewhere_equals_the_reference(fill):
    nodes = [node_dict(f"m{i}", 4, "z0") for i in range(3)]
    bound = [pod_dict(f"a{i}", 700, node="m0") for i in range(3)]
    if fill == "full":
        bound += [pod_dict("big1", 3800, node="m1"),
                  pod_dict("big2", 3800, node="m2")]
    got = []
    for pkg in (PORT, JAX):
        n, b, _, _ = build(pkg, nodes, bound, [], [])
        its = [p for p in b if p.spec.node_name == "m0"]
        kw = {"device": "cpu"} if pkg is PORT else {}
        got.append(pkg["sim"].pods_fit_elsewhere(n, b, "m0", its, **kw))
    assert got[0] == got[1] == (fill == "free")


def host_port_dict(name, cpu_milli=500):
    d = pod_dict(name, cpu_milli)
    d["spec"]["containers"][0]["ports"] = [{"containerPort": 80,
                                            "hostPort": 8080}]
    return d


@pytest.mark.parametrize("seed", (7, 21, 42))
def test_whatif_keeps_host_only_rows_as_the_reference(seed):
    """A host-port pod in the middle of the pending list keeps its row:
    the port's ``run_whatif`` (scan and serial arms) gives the JAX
    package's assignments, same length, order and values, -1 on the
    host-only row, and the same per-column counts."""
    nodes, bound, pending, groups = world(seed)
    mid = len(pending) // 2
    pending = pending[:mid] + [host_port_dict("hp0")] + pending[mid:]
    got = []
    for pkg in (PORT, JAX, "serial"):
        n, b, p, gs = build(PORT if pkg == "serial" else pkg, nodes, bound,
                            pending, groups)
        virt = [gs[0][0].node_template(f"whatif-{i}") for i in range(4)]
        sim = JAX["sim"] if pkg is JAX else simulator
        kw = {} if pkg is JAX else (
            {"serial": True} if pkg == "serial" else {"device": "cpu"})
        got.append(sim.run_whatif(n, b, p, new_nodes=virt, **kw))
    port, ref, serial = got
    assert len(port.assignments) == len(ref.assignments) == len(pending)
    for res in (port, serial):
        np.testing.assert_array_equal(res.assignments,
                                      np.asarray(ref.assignments))
        np.testing.assert_array_equal(res.counts, np.asarray(ref.counts))
    assert port.assignments[mid] == -1 and port.batch.inexpressible[mid]
    assert (port.assignments >= 0).sum() >= 10


@pytest.mark.parametrize("seed", (7, 21))
@pytest.mark.parametrize("expander", ("least-waste", "priority"))
def test_plan_scale_up_with_a_host_only_pod_equals_the_reference(
        seed, expander):
    nodes, bound, pending, groups = world(seed)
    pending = pending[:5] + [host_port_dict("hp0"), host_port_dict(
        "hp1", 1000)] + pending[5:]
    plans = []
    for pkg in (PORT, JAX):
        n, b, p, gs = build(pkg, nodes, bound, pending, groups)
        kw = {"device": "cpu"} if pkg is PORT else {}
        plans.append(pkg["sim"].plan_scale_up(
            n, b, p, gs, expander=expander, max_virtual=12, max_pods=30,
            **kw))
    assert options(plans[0]) == options(plans[1])
    assert plans[0].chosen is not None


@pytest.mark.parametrize("fill", ("free", "full"))
def test_pods_fit_elsewhere_with_a_host_only_pod_equals_the_reference(fill):
    """The port answers False without a solve; the reference solves, and
    its scan leaves the host-only row unplaced: the same verdict, with
    room elsewhere or not."""
    nodes = [node_dict(f"m{i}", 4, "z0") for i in range(3)]
    bound = [pod_dict(f"a{i}", 700, node="m0") for i in range(2)]
    hp = host_port_dict("hp")
    hp["spec"]["nodeName"] = "m0"
    bound.append(hp)
    if fill == "full":
        bound += [pod_dict("big1", 3800, node="m1"),
                  pod_dict("big2", 3800, node="m2")]
    got = []
    for pkg in (PORT, JAX):
        n, b, _, _ = build(pkg, nodes, bound, [], [])
        its = [p for p in b if p.spec.node_name == "m0"]
        kw = {"device": "cpu"} if pkg is PORT else {}
        got.append(pkg["sim"].pods_fit_elsewhere(n, b, "m0", its, **kw))
        without = [p for p in its if p.metadata.name != "hp"]
        assert pkg["sim"].pods_fit_elsewhere(n, b, "m0", without, **kw) \
            == (fill == "free")
    assert got == [False, False]


def _twin_reconcile(pkg, store, condition):
    nodes = [node_dict("full0", 4, "z0")]
    bound = [pod_dict("filler", 3800, node="full0")]
    pending = [pod_dict(f"w{i}", 1000) for i in range(10)]
    for d in nodes:
        store.add_node(pkg["node"](copy.deepcopy(d)))
    store.create_pods([pkg["pod"](copy.deepcopy(d))
                       for d in bound + pending])
    for d in pending:
        store.patch_pod_condition("default", d["metadata"]["name"],
                                  condition("PodScheduled", "False",
                                            "Unschedulable", "test"))


def test_reconcile_once_scales_up_like_the_reference():
    added = []
    for pkg, store, factory, cond, ca_cls, registry_cls in (
            (PORT, ClusterStore(), SharedInformerFactory, PodCondition,
             ClusterAutoscaler, NodeGroupRegistry),
            (JAX, JaxStore(), JaxFactory, JaxPodCondition,
             jax_controller.ClusterAutoscaler,
             jax_nodegroups.NodeGroupRegistry)):
        _twin_reconcile(pkg, store, cond)
        registry = registry_cls()
        registry.add(pkg["group"]("ng", cpu="4", memory="16Gi", max_size=8))
        kw = {"device": "cpu"} if pkg is PORT else {}
        ca = ca_cls(store, factory(store), registry=registry, **kw)
        ca.reconcile_once()
        added.append((sorted(n.name for n in store.list_nodes()),
                      ca.whatif_solves, ca.scale_up_events,
                      ca.provisioner.provisioned_total))
        ca.stop()
    assert added[0] == added[1]
    assert added[0][2] == 1 and added[0][3] == 3   # 10 x 1 cpu on 4-cpu


def test_scale_down_drains_within_the_pdb():
    """An idle group node whose safe-to-evict pod fits elsewhere is
    cordoned, its pod evicted only while the PDB allows, then deleted."""
    store = ClusterStore()
    registry = NodeGroupRegistry()
    group = registry.add(NodeGroup("ng", cpu="4", memory="16Gi",
                                   min_size=0, max_size=4))
    for i in range(2):
        store.add_node(group.node_template(i))
    p = Pod.from_dict(pod_dict("lone", 500, node="ng-1"))
    p.metadata.annotations[SAFE_TO_EVICT_ANNOTATION] = "true"
    store.create_pods([Pod.from_dict(pod_dict("busy", 2500, node="ng-0")),
                       p])
    pdb = PodDisruptionBudget(
        ObjectMeta(name="pdb"), LabelSelector(match_labels={"app": "x"}),
        status=PodDisruptionBudgetStatus(disruptions_allowed=0))
    store.add_pdb(pdb)
    ca = ClusterAutoscaler(store, SharedInformerFactory(store),
                           registry=registry, device="cpu")
    ca.scale_down_unneeded_time = 0.0
    ca.reconcile_once()     # ng-1 cordoned (ng-0 is over the threshold)
    assert store.get_node("ng-1").spec.unschedulable
    assert ca.whatif_solves == 1
    ca.reconcile_once()     # the budget holds the pod
    assert store.get_pod("default", "lone") is not None
    pdb.status.disruptions_allowed = 1
    store.add_pdb(pdb)      # a new status generation
    ca.reconcile_once()     # evicted
    assert store.get_pod("default", "lone") is None
    ca.reconcile_once()     # empty: deleted
    assert store.get_node("ng-1") is None and ca.scale_down_events == 1
    ca.stop()


def test_provisioner_boots_after_the_latency():
    store = ClusterStore()
    registry = NodeGroupRegistry()
    group = registry.add(NodeGroup("ng", boot_latency=0.2))
    prov = SimulatedProvisioner(store, registry)
    prov.start()
    try:
        assert prov.provision(group, 2) == ["ng-0", "ng-1"]
        assert prov.group_size("ng") == 2 and prov.live_count("ng") == 0
        assert len(prov.booting_templates("ng")) == 2
        deadline = time.monotonic() + 5.0
        while prov.live_count("ng") < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert prov.live_count("ng") == 2 and prov.booting_count("ng") == 0
    finally:
        prov.stop()


def test_workqueue_dedups_and_requeues_once():
    q = WorkQueue()
    q.add("a")
    q.add("a")
    assert len(q) == 1
    item = q.get(timeout=0.1)
    q.add("a")              # while processing: once more after done
    assert len(q) == 0
    q.done(item)
    assert q.get(timeout=0.1) == "a"
    rq = RateLimitingQueue()
    rq.add_rate_limited("b")
    assert rq.num_requeues("b") == 1 and rq.get(timeout=1.0) == "b"
    rq.shutdown()


def test_informer_replays_and_follows_the_store():
    store = ClusterStore()
    store.add_node(Node.from_dict(node_dict("n0", 4, "z0")))
    factory = SharedInformerFactory(store)
    seen = []
    factory.informer_for("Node").add_event_handler(
        on_add=lambda o: seen.append(("add", o.name)),
        on_delete=lambda o: seen.append(("del", o.name)))
    factory.start()
    try:
        assert factory.wait_for_cache_sync()
        store.add_node(Node.from_dict(node_dict("n1", 4, "z0")))
        store.delete_node("n0")
        deadline = time.monotonic() + 5.0
        while len(seen) < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert seen == [("add", "n0"), ("add", "n1"), ("del", "n0")]
        assert [n.name for n in factory.lister_for("Node").list()] == ["n1"]
    finally:
        factory.stop()
