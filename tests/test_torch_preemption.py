"""Preemption in the port against the JAX package: the serial PostFilter
(evict, nominate), the batch path's fallback for a few declined pods,
the mass-decline path (statuses from the static masks, the victim
planner's plans executed in bulk, PostFilter with the screen's hints),
PreemptionPolicy Never and PodDisruptionBudgets, and the small
Preemption and Unschedulable rows, in the pipelined and serialized arms
with the device mirror on and off. Each case compares, for every pod the
case created: deleted or not, its node, its ``PodScheduled`` condition
and its nominated node. The screen's candidates and the planner's plans
are compared on seeded snapshots. Tolerance: exact equality.

The JAX scheduler is built with ``parallelism=1`` and the module-level
``random`` seeded as the port's ``rng``."""

import copy
import random
import time

import numpy as np
import pytest

from kubernetes_tpu.api.labels import LabelSelector as JaxLabelSelector
from kubernetes_tpu.api.types import (
    ObjectMeta as JaxObjectMeta,
    Node as JaxNode,
    Pod as JaxPod,
    PodDisruptionBudget as JaxPDB,
)
from kubernetes_tpu.scheduler import preemption_screen as jax_screen
from kubernetes_tpu.scheduler.snapshot import new_snapshot as jax_snapshot
from kubernetes_tpu_torch.api.types import Node, Pod, PodDisruptionBudget
from kubernetes_tpu_torch.harness import workloads
from kubernetes_tpu_torch.scheduler import preemption_screen
from kubernetes_tpu_torch.scheduler.snapshot import new_snapshot
from test_torch_framework import jax_scheduler, port_scheduler
from test_torch_pipeline import pump
from test_torch_serial import batch_arm, outcome

ARMS = [(p, m) for p in (True, False) for m in (True, False)]


def node(i, cpu="4", labels=None):
    return {"metadata": {"name": f"n{i}", "labels": {
        "kubernetes.io/hostname": f"n{i}", **(labels or {})}},
        "status": {"capacity": {"cpu": cpu, "memory": "8Gi",
                                "pods": "110"}}}


def pod(name, cpu, priority=None, labels=None, never=False):
    spec = {"containers": [{"name": "c", "resources": {"requests": {
        "cpu": cpu, "memory": "100Mi"}}}]}
    if priority is not None:
        spec["priority"] = priority
    if never:
        spec["preemptionPolicy"] = "Never"
    return {"metadata": {"name": name, "uid": f"u-{name}",
                         "labels": dict(labels or {})}, "spec": spec}


def pdb(ref, name, labels, allowed):
    if ref:
        b = JaxPDB(metadata=JaxObjectMeta(name=name, namespace="default"),
                   label_selector=JaxLabelSelector(match_labels=labels))
        b.status.disruptions_allowed = allowed
        return b
    return PodDisruptionBudget.from_dict({
        "metadata": {"name": name},
        "spec": {"selector": {"matchLabels": labels}},
        "status": {"disruptionsAllowed": allowed}})


def drain_serial(sched, ref, timeout=20.0):
    """Serial cycles until nothing is due an attempt, waiting out
    backoff."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        sched.queue.flush_backoff_completed()
        if sched.schedule_one(pop_timeout=0.0):
            continue
        if sched.queue.pending_active_count() == 0:
            break
        time.sleep(0.02)
    else:
        raise AssertionError("scheduler did not drain in time")
    if ref:
        assert sched.wait_for_inflight_bindings()


def create(arm_store, ref, dicts):
    make = JaxPod.from_dict if ref else Pod.from_dict
    arm_store.create_pods([make(copy.deepcopy(d)) for d in dicts])


# ----------------------------------------------------------------------
# the serial path's PostFilter
def serial_case(ref, second, seed=0):
    nodes = [node(1, cpu="2")]
    sched = (jax_scheduler(nodes, []) if ref
             else port_scheduler(nodes, [], seed=seed))
    if ref:
        random.seed(seed)
    try:
        create(sched.client, ref, [pod("victim", "2", priority=1)])
        drain_serial(sched, ref)
        assert sched.client.get_pod("default", "victim").spec.node_name
        create(sched.client, ref, [second])
        drain_serial(sched, ref)
        names = ["victim", second["metadata"]["name"]]
        return outcome(sched.client, names)
    finally:
        sched.stop()


def test_higher_priority_preempts_like_the_reference():
    vip = pod("vip", "2", priority=100)
    got, want = serial_case(False, vip), serial_case(True, vip)
    assert got == want
    assert got["victim"] == "deleted"
    assert got["vip"][0] == "n1" and got["vip"][2] == "n1"
    assert got["vip"][1] == [("False", "Unschedulable",
                              "0/1 nodes are available: 1 Insufficient cpu.")]


def test_preemption_policy_never_like_the_reference():
    gentle = pod("gentle", "2", priority=100, never=True)
    got, want = serial_case(False, gentle), serial_case(True, gentle)
    assert got == want
    assert got["victim"][0] == "n1"
    assert got["gentle"][0] == "" and got["gentle"][2] == ""


# ----------------------------------------------------------------------
# the batch path
def batch_case(ref, pipeline, mirror, nodes, waves, limit=None, pdbs=(),
               seed=0, max_batch=16):
    """Create each wave and pump it; returns the outcome of every pod."""
    arm = batch_arm(nodes, ref, pipeline, mirror, seed, max_batch=max_batch)
    if limit is not None:
        arm.bs.DECLINED_SERIAL_LIMIT = limit
    for name, labels, allowed in pdbs:
        arm.store.add_pdb(pdb(ref, name, labels, allowed))
    try:
        names = []
        for wave in waves:
            create(arm.store, ref, wave)
            names += [d["metadata"]["name"] for d in wave]
            pump(arm)
        return outcome(arm.store, names)
    finally:
        arm.sched.stop()


@pytest.mark.parametrize("pipeline,mirror", ARMS)
def test_preemption_via_fallback_like_the_reference(pipeline, mirror):
    """One declined pod takes the serial path, which preempts; the next
    batch binds it."""
    kw = dict(nodes=[node(0, cpu="2")],
              waves=[[pod("victim", "2", priority=1)],
                     [pod("vip", "2", priority=100)]])
    got = batch_case(False, pipeline, mirror, **kw)
    assert got == batch_case(True, pipeline, mirror, **kw)
    assert got["victim"] == "deleted" and got["vip"][0] == "n0"


def _fillers(n):
    return [pod(f"low{i}", "3", priority=0) for i in range(n)]


@pytest.mark.parametrize("pipeline,mirror", ARMS)
def test_mass_decline_respects_preemption_policy_never(pipeline, mirror):
    """Declined pods of policy Never evict no one, and fail with the
    status built from the static masks."""
    kw = dict(nodes=[node(i) for i in range(3)], limit=0,
              waves=[_fillers(3),
                     [pod(f"hi{i}", "3", priority=100, never=True)
                      for i in range(12)]])
    got = batch_case(False, pipeline, mirror, **kw)
    assert got == batch_case(True, pipeline, mirror, **kw)
    assert all(got[f"low{i}"] != "deleted" for i in range(3))
    assert not any(got[f"hi{i}"][0] for i in range(12))
    assert got["hi0"][1] == [(
        "False", "Unschedulable", "0/3 nodes are available: 3 node(s) had "
        "insufficient resources or violated topology/affinity constraints.")]


@pytest.mark.parametrize("pipeline,mirror", ARMS)
def test_mass_decline_with_pdb_covered_victims(pipeline, mirror):
    """The planner leaves PDB-covered victims alone: preemptors past the
    uncovered ones fall to PostFilter with the screen's hints, whose dry
    run counts the budget's violations."""
    guarded = {"app": "guarded"}
    fill = [pod(f"g{i}", "3", priority=0, labels=guarded) for i in range(2)]
    fill += [pod(f"u{i}", "3", priority=0) for i in range(4)]
    kw = dict(nodes=[node(i) for i in range(6)], limit=0,
              pdbs=[("pdb", guarded, 0)],
              waves=[fill, [pod(f"hi{i}", "3", priority=100)
                            for i in range(6)]])
    got = batch_case(False, pipeline, mirror, **kw)
    assert got == batch_case(True, pipeline, mirror, **kw)
    assert all(got[f"u{i}"] == "deleted" for i in range(4))
    assert sum(1 for i in range(6) if got[f"hi{i}"][0]) >= 4


def _preemption_row(n):
    ops = workloads.preemption(n, n, n)
    nodes = [ops[0]["nodeTemplate"](i) for i in range(n)]
    low = [ops[1]["podTemplate"](i) for i in range(n)]
    high = [ops[3]["podTemplate"](n + i) for i in range(n)]
    return nodes, [low, high]


@pytest.mark.parametrize("pipeline,mirror", ARMS)
def test_mass_decline_plans_like_the_reference(pipeline, mirror):
    """The Preemption row with every batch mass-declined
    (``DECLINED_SERIAL_LIMIT = 0``, batches of 8): each preemptor evicts
    exactly one priority-1 pod and binds in the cycle of its plan."""
    nodes, waves = _preemption_row(20)
    kw = dict(nodes=nodes, waves=waves, limit=0, max_batch=8)
    got = batch_case(False, pipeline, mirror, **kw)
    # the JAX mirror-on arm's catch-up skips the plans' placements
    # (journaled as a solve's own): held to its mirror-off arm
    assert got == batch_case(True, pipeline, False, **kw)
    deleted = [n for n, o in got.items() if o == "deleted"]
    assert len(deleted) == 20 and all(n.startswith("pod-") and
                                      int(n[4:]) < 20 for n in deleted)
    assert all(o[0] for n, o in got.items() if o != "deleted")


@pytest.mark.parametrize("pipeline,mirror", ARMS)
def test_small_preemption_row_like_the_reference(pipeline, mirror):
    """The Preemption row at 50 nodes / 50 / 50 in one batch a wave."""
    nodes, waves = _preemption_row(50)
    kw = dict(nodes=nodes, waves=waves, max_batch=64)
    got = batch_case(False, pipeline, mirror, **kw)
    assert got == batch_case(True, pipeline, mirror, **kw)
    assert sum(1 for o in got.values() if o == "deleted") == 50
    assert all(o[0] for o in got.values() if o != "deleted")


@pytest.mark.parametrize("pipeline,mirror", ARMS)
def test_small_unschedulable_row_like_the_reference(pipeline, mirror):
    """The Unschedulable row at 50 nodes: 40 pods no node matches stay
    pending with the static-mask status, no PostFilter; 100 plain pods
    bind around them."""
    ops = workloads.unschedulable(50, 40, 100)
    nodes = [ops[0]["nodeTemplate"](i) for i in range(50)]
    impossible = [ops[1]["podTemplate"](i) for i in range(40)]
    plain = [ops[2]["podTemplate"](40 + i) for i in range(100)]

    def run(ref):
        # batches of 40: the impossible pods fail in a batch of their own,
        # so no bind of the same cycle sends them to backoff, whose
        # retries a wall-clock flush could split into small declines
        arm = batch_arm(nodes, ref, pipeline, mirror, 0, max_batch=40)
        try:
            create(arm.store, ref, impossible)
            create(arm.store, ref, plain)
            pump(arm)
            names = [d["metadata"]["name"] for d in impossible + plain]
            return outcome(arm.store, names), arm
        finally:
            arm.sched.stop()

    got, port = run(False)
    want, _ = run(True)
    assert got == want
    assert all(got[f"pod-{40 + i}"][0] for i in range(100))
    msg = ("0/50 nodes are available: 50 node(s) didn't satisfy the pod's "
           "node-static predicates.")
    assert all(got[f"pod-{i}"] == ("", [("False", "Unschedulable", msg)], "")
               for i in range(40))
    assert port.sched.framework.post_filter_runs == 0


# ----------------------------------------------------------------------
# the screen and the planner on seeded snapshots
def seeded_snapshot_dicts(seed, n_nodes=16, n_pods=40):
    rng = np.random.default_rng(seed)
    nodes = [node(i, cpu=str(int(rng.choice([4, 8]))))
             for i in range(n_nodes)]
    pods = []
    for i in range(n_pods):
        d = pod(f"e{i}", f"{int(rng.choice([500, 1000, 2000]))}m",
                priority=int(rng.choice([0, 1, 5, 50])),
                labels={"app": str(rng.choice(["a", "b"]))})
        d["spec"]["nodeName"] = f"n{int(rng.integers(n_nodes))}"
        pods.append(d)
    preemptors = [pod(f"p{i}", f"{int(rng.choice([1000, 3000]))}m",
                      priority=int(rng.choice([1, 10, 100])))
                  for i in range(8)]
    mask = rng.random(n_nodes) < 0.8
    return nodes, pods, preemptors, mask


def _snapshots(nodes, pods):
    return (new_snapshot([Pod.from_dict(copy.deepcopy(d)) for d in pods],
                         [Node.from_dict(copy.deepcopy(d)) for d in nodes]),
            jax_snapshot([JaxPod.from_dict(copy.deepcopy(d)) for d in pods],
                         [JaxNode.from_dict(copy.deepcopy(d))
                          for d in nodes]))


@pytest.mark.parametrize("seed", (0, 1, 2, 3))
def test_screen_candidates_equal_the_reference(seed):
    nodes, pods, preemptors, mask = seeded_snapshot_dicts(seed)
    snap, ref_snap = _snapshots(nodes, pods)
    screen = preemption_screen.build_screen(snap)
    ref = jax_screen.build_screen(ref_snap)
    nonempty = 0
    for bi, d in enumerate(preemptors):
        p, rp = Pod.from_dict(copy.deepcopy(d)), JaxPod.from_dict(d)
        for kw in ({}, {"static_mask": mask, "rotation": bi, "k": 4}):
            got = screen.candidates_for(p, **kw)
            assert got == ref.candidates_for(rp, **kw)
            nonempty += bool(got)
    assert nonempty


@pytest.mark.parametrize("seed", (0, 1, 2, 3))
def test_planner_plans_equal_the_reference(seed):
    nodes, pods, preemptors, mask = seeded_snapshot_dicts(seed)
    guarded = [("pdb", {"app": "b"}, 1)]
    for pdbs in ((), guarded):
        snap, ref_snap = _snapshots(nodes, pods)
        planner = preemption_screen.build_victim_planner(
            snap, pdbs=[pdb(False, *b) for b in pdbs])
        ref = jax_screen.build_victim_planner(
            ref_snap, pdbs=[pdb(True, *b) for b in pdbs])
        planned = 0
        for d in preemptors:
            p, rp = Pod.from_dict(copy.deepcopy(d)), JaxPod.from_dict(d)
            got = planner.plan_group(p, 3, static_mask=mask)
            want = ref.plan_group(rp, 3, static_mask=mask)
            assert [(n, [v.name for v in vs]) for n, vs in got] == \
                [(n, [v.name for v in vs]) for n, vs in want]
            planned += len(got)
            if pdbs:
                assert not any(v.metadata.labels.get("app") == "b"
                               for _, vs in got for v in vs)
        assert planned


def test_planner_never_proposes_pdb_covered_victims():
    """A pod covered by a PodDisruptionBudget is no victim of a plan, even
    with budget left (the dry run owns violation counting), in both
    packages."""
    nodes = [node(0)]
    guard = pod("guard", "3", priority=0, labels={"app": "guarded"})
    guard["spec"]["nodeName"] = "n0"
    hi = pod("hi", "3", priority=100)
    snap, ref_snap = _snapshots(nodes, [guard])
    for ref, s, screen in ((False, snap, preemption_screen),
                           (True, ref_snap, jax_screen)):
        planner = screen.build_victim_planner(
            s, pdbs=[pdb(ref, "pdb", {"app": "guarded"}, 5)])
        make = JaxPod.from_dict if ref else Pod.from_dict
        assert planner.plan_group(make(copy.deepcopy(hi)), 1) == []
        # without the budget the guard is a victim
        planner = screen.build_victim_planner(s, pdbs=[])
        got = planner.plan_group(make(copy.deepcopy(hi)), 1)
        assert [(n, [v.name for v in vs]) for n, vs in got] == \
            [("n0", ["guard"])]


def test_store_counts_bound_pods_through_preemption():
    """The store's bound-pod counter (what the throughput sampler reads)
    equals a scan after binds, evictions and updates."""
    nodes, waves = _preemption_row(20)
    arm = batch_arm(nodes, False, True, True, 0, max_batch=8)
    arm.bs.DECLINED_SERIAL_LIMIT = 0
    try:
        def scan():
            return sum(1 for p in arm.store.list_pods() if p.spec.node_name)

        for wave in waves:
            create(arm.store, False, wave)
            assert arm.store.count_bound() == scan()
            pump(arm)
            assert arm.store.count_bound() == scan() == 20
        p = arm.store.get_pod("default", "pod-20")
        moved = Pod.from_dict({"metadata": {"name": "pod-20"},
                               "spec": {"containers": [{"name": "c"}]}})
        arm.store.update_pod(moved)
        assert arm.store.count_bound() == scan() == 19
        assert p.spec.node_name
    finally:
        arm.sched.stop()
