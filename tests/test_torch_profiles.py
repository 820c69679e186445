"""Profiles, parallelism and the batchable-profile rule, against the JAX
package:

- two profiles (the default one and one packing with MostAllocated),
  serial: every pod on the same node as the JAX scheduler puts it, ties
  drawn from the same seed;
- ``parallelism=1``: the feasible lists and the round-robin start index
  equal the reference's, pod after pod, past 100 nodes (the adaptive
  sample); ``parallelism=16`` with ``percentageOfNodesToScore: 100``:
  the same feasible set;
- the ``PreferNominatedNode`` gate: a nominated node that passes is taken
  without a search, as in the reference;
- the reference's Policy fault: a Policy profile's pods, with the batch
  path on, bind as the JAX serial arm binds them (MostAllocated packs);
  the JAX batch arm, which solves every ``default-scheduler`` pod with
  the provider defaults, spreads them instead, and the test keeps that
  difference documented; a profile of the default plugin set whose solve
  plugins have arguments (``defaultConstraints``, resource weights) goes
  serial too, and binds as the JAX serial arm does;
- the default and the gang scheduling providers' profiles still batch.

Tolerance: exact equality."""

import copy
import random

import pytest

from kubernetes_tpu.api.types import Node as JaxNode, Pod as JaxPod
from kubernetes_tpu.apiserver.store import ClusterStore as JaxStore
from kubernetes_tpu.config import policy as jax_policy
from kubernetes_tpu.config.feature_gates import FeatureGates as JaxGates
from kubernetes_tpu.config.types import (
    KubeSchedulerConfiguration as JaxConfig,
)
from kubernetes_tpu.ops.pallas_solver import XlaPlanesBackend
from kubernetes_tpu.scheduler.framework.cycle_state import (
    CycleState as JaxCycleState,
)
from kubernetes_tpu.scheduler.scheduler import Scheduler as JaxScheduler
from kubernetes_tpu.sidecar import (
    attach_batch_scheduler as jax_attach_batch_scheduler,
)
from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.config import policy
from kubernetes_tpu_torch.config.feature_gates import FeatureGates
from kubernetes_tpu_torch.harness import perf, workloads
from kubernetes_tpu_torch.scheduler.framework.cycle_state import CycleState
from kubernetes_tpu_torch.scheduler.scheduler import Scheduler
from kubernetes_tpu_torch.sidecar import (
    attach_batch_scheduler,
    batchable_profile,
)
from test_torch_framework import cluster_dicts, pending_dicts
from test_torch_pipeline import pump
from test_torch_serial import outcome, serial_pass

TWO_PROFILES = {
    "parallelism": 1,
    "profiles": [
        {"schedulerName": "default-scheduler"},
        {"schedulerName": "packing", "plugins": {"score": {
            "disabled": [{"name": "NodeResourcesLeastAllocated"}],
            "enabled": [{"name": "NodeResourcesMostAllocated",
                         "weight": 1}]}}}]}
POLICY = {"predicates": [{"name": "PodFitsResources"}],
          "priorities": [{"name": "MostRequestedPriority", "weight": 1}]}


def _stores(nodes, existing, ref):
    if ref:
        store = JaxStore()
        for d in nodes:
            store.add_node(JaxNode.from_dict(copy.deepcopy(d)))
        for d in existing:
            store.create_pod(JaxPod.from_dict(copy.deepcopy(d)))
        return store
    store = ClusterStore()
    for d in nodes:
        store.add_node(Node.from_dict(copy.deepcopy(d)))
    store.create_pods([Pod.from_dict(copy.deepcopy(d)) for d in existing])
    return store


def _create(store, config: dict, ref: bool, seed: int, gates=None):
    if ref:
        sched = JaxScheduler.create(store, config=JaxConfig.from_dict(config),
                                    feature_gates=JaxGates(gates or {}))
        random.seed(seed)
    else:
        sched = Scheduler.create(store, config=config,
                                 feature_gates=FeatureGates(gates or {}),
                                 rng=random.Random(seed))
    return sched


@pytest.mark.parametrize("seed", (0, 1, 2, 3))
def test_two_profiles_serial_equal_the_reference(seed):
    nodes, existing = cluster_dicts(seed, n_nodes=30, n_existing=20)
    pending = pending_dicts(seed, 30)
    for i, d in enumerate(pending):
        if i % 2:
            d["spec"]["schedulerName"] = "packing"
    pending.append(dict(copy.deepcopy(pending[0]),
                        metadata={"name": "stray", "uid": "u-stray"}))
    pending[-1]["spec"]["schedulerName"] = "nobody"
    results = []
    for ref in (False, True):
        store = _stores(nodes, existing, ref)
        sched = _create(store, TWO_PROFILES, ref, seed)
        sched.start()
        pod_cls = JaxPod if ref else Pod
        store.create_pods([pod_cls.from_dict(copy.deepcopy(d))
                           for d in pending])
        try:
            serial_pass(sched, ref)
            results.append(outcome(store, [d["metadata"]["name"]
                                           for d in pending]))
        finally:
            sched.stop()
    got, want = results
    assert got == want
    assert got["stray"] == ("", [], "")
    placed = {n for n, (node, _, _) in got.items() if node}
    assert any(int(n[1:]) % 2 for n in placed if n != "stray")


def _fit_sequence(sched, fwk, pods, state_cls):
    out = []
    for pod in pods:
        state = state_cls()
        feasible, _ = sched.algorithm.find_nodes_that_fit_pod(state, fwk,
                                                              pod)
        out.append(([ni.node.name for ni in feasible],
                    sched.algorithm.next_start_node_index))
    return out


@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("parallelism,percentage", ((1, 0), (1, 30),
                                                    (16, 100)))
def test_feasible_lists_and_start_index(seed, parallelism, percentage):
    nodes, existing = cluster_dicts(seed, n_nodes=240, n_existing=60)
    pending = pending_dicts(seed, 12)
    config = {"parallelism": parallelism,
              "percentageOfNodesToScore": percentage}
    seqs = []
    for ref in (False, True):
        sched = _create(_stores(nodes, existing, ref), config, ref, seed)
        sched.start()
        try:
            sched.algorithm.update_snapshot()
            fwk = sched.profiles["default-scheduler"]
            pod_cls = JaxPod if ref else Pod
            seqs.append(_fit_sequence(
                sched, fwk, [pod_cls.from_dict(copy.deepcopy(d))
                             for d in pending],
                JaxCycleState if ref else CycleState))
        finally:
            sched.stop()
    got, want = seqs
    if parallelism == 1:
        assert got == want
        if seed == 0:
            # the sample stops short of the nodes, and the index moves
            assert len({start for _, start in got}) > 1
    else:
        # workers finish in any order: the same set, every node looked at
        assert [sorted(f) for f, _ in got] == [sorted(f) for f, _ in want]
        assert all(start == 0 for _, start in got + want)


def test_prefer_nominated_node_gate():
    """With the gate on, a pod nominated to a node that passes goes there
    without a search (the start index stays); with it off, the search
    runs. As in the reference."""
    nodes, existing = cluster_dicts(4, n_nodes=150, n_existing=20)
    d = pending_dicts(4, 1)[0]
    d["status"] = {"nominatedNodeName": "n77"}
    for gate in (True, False):
        seqs = []
        for ref in (False, True):
            sched = _create(_stores(nodes, existing, ref),
                            {"parallelism": 1}, ref, 4,
                            gates={"PreferNominatedNode": gate})
            sched.start()
            try:
                sched.algorithm.update_snapshot()
                pod = (JaxPod if ref else Pod).from_dict(copy.deepcopy(d))
                seqs.append(_fit_sequence(
                    sched, sched.profiles["default-scheduler"], [pod],
                    JaxCycleState if ref else CycleState))
            finally:
                sched.stop()
        assert seqs[0] == seqs[1]
        if gate:
            assert seqs[0] == [(["n77"], 0)]
        else:
            assert len(seqs[0][0][0]) > 1


# ----------------------------------------------------------------------
# the reference's Policy fault
def _probe_nodes():
    return [{"metadata": {"name": f"n{i}"},
             "status": {"capacity": {"cpu": "8", "memory": "16Gi",
                                     "pods": "110"}}} for i in range(3)]


def _probe_pods():
    return [{"metadata": {"name": f"p{i}", "uid": f"u-p{i}"},
             "spec": {"containers": [{"name": "c", "resources": {
                 "requests": {"cpu": "1"}}}]}} for i in range(6)]


def _policy_arm(ref, batch, seed=7):
    """The Motivation's probe: 3 nodes of 8 cpu, 6 pods of 1 cpu created
    before start, a Policy of PodFitsResources and MostRequestedPriority
    (one worker); the batch path on or off, serialized."""
    store = _stores(_probe_nodes(), _probe_pods(), ref)
    gates = {"TPUBatchScheduler": batch}
    if ref:
        cfg = jax_policy.policy_to_config(POLICY)
        cfg.parallelism = 1
        sched = JaxScheduler.create(store, config=cfg,
                                    feature_gates=JaxGates(gates))
        bs = jax_attach_batch_scheduler(sched, max_batch=8, pipeline=False,
                                        backend=XlaPlanesBackend(),
                                        adaptive_chunk=False)
        random.seed(seed)
    else:
        cfg = policy.policy_to_config(POLICY)
        cfg.parallelism = 1
        sched = Scheduler.create(store, config=cfg,
                                 feature_gates=FeatureGates(gates),
                                 rng=random.Random(seed))
        bs = attach_batch_scheduler(sched, max_batch=8, device="cpu",
                                    pipeline=False)
    assert (bs is not None) == batch
    sched.start()
    try:
        if bs is None:
            serial_pass(sched, ref)
        else:
            from types import SimpleNamespace
            pump(SimpleNamespace(sched=sched, bs=bs, store=store))
        return [store.get_pod("default", f"p{i}").spec.node_name
                for i in range(6)], bs
    finally:
        sched.stop()


def test_policy_profile_batches_as_the_reference_serial_arm():
    want, _ = _policy_arm(ref=True, batch=False)
    got, bs = _policy_arm(ref=False, batch=True)
    assert got == want
    # MostAllocated packs: every pod on the one node the first tie chose
    assert len(set(want)) == 1 and want[0]
    assert bs.batchable_profiles == {"default-scheduler": False}
    assert bs.session.backend.solves == 0
    # the port's serial arm agrees too
    assert _policy_arm(ref=False, batch=False)[0] == want
    # the JAX batch arm solves the Policy's pods with the provider
    # defaults, which spread them: the fault ROADMAP.md section C records
    jax_batch, _ = _policy_arm(ref=True, batch=True)
    assert jax_batch != want
    assert jax_batch == ["n0", "n1", "n2", "n0", "n1", "n2"]


@pytest.mark.parametrize("provider_name", ("DefaultProvider",
                                           "GangSchedulingProvider"))
def test_default_and_gang_profiles_still_batch(provider_name):
    """``run_workload`` (the gang provider) and a default-provider
    scheduler batch every plain pod: the solve runs, the serial path
    never."""
    sched = Scheduler.create(ClusterStore(), provider=provider_name,
                             feature_gates=FeatureGates(
                                 {"TPUBatchScheduler": True}))
    bs = attach_batch_scheduler(sched, device="cpu", max_batch=64)
    assert bs.batchable_profiles == {"default-scheduler": True}
    for gates in ({}, {"DefaultPodTopologySpread": True}):
        fg = FeatureGates(gates)
        s2 = Scheduler.create(ClusterStore(), provider=provider_name,
                              feature_gates=fg)
        assert batchable_profile(s2.framework, fg)
    serial = []

    def count_serial(bs):
        real = bs.sched.schedule_pod_serial

        def counted(qpi):
            serial.append(qpi.pod.name)
            return real(qpi)
        bs.sched.schedule_pod_serial = counted

    res = perf.run_workload("SchedulingBasic",
                            workloads.make_workload("SchedulingBasic", 50, 0,
                                                    200),
                            device="cpu", max_batch=64,
                            configure=count_serial)
    assert all(res.placements.values())
    assert res.solves > 0 and serial == []


def test_batchable_rule_refuses_other_plugin_sets():
    for plugins in (
            {"score": {"disabled": [{"name": "NodeResourcesLeastAllocated"}],
                       "enabled": [{"name": "NodeResourcesMostAllocated"}]}},
            {"score": {"enabled": [{"name": "ImageLocality", "weight": 2}],
                       "disabled": [{"name": "ImageLocality"}]}},
            {"filter": {"disabled": [{"name": "NodePorts"}]}}):
        sched = Scheduler.create(ClusterStore(), config={"profiles": [
            {"schedulerName": "x", "plugins": plugins}]})
        assert not batchable_profile(sched.framework, sched.feature_gates)
    sched = Scheduler.create(ClusterStore(),
                             provider="ClusterAutoscalerProvider")
    assert not batchable_profile(sched.framework, sched.feature_gates)


SPREAD_ARGS = {"name": "PodTopologySpread", "args": {"defaultConstraints": [
    {"maxSkew": 1, "topologyKey": "zone",
     "whenUnsatisfiable": "DoNotSchedule",
     "labelSelector": {"matchLabels": {"app": "a"}}}]}}
CPU_WEIGHT_ARGS = {"name": "NodeResourcesLeastAllocated", "args": {
    "resources": [{"name": "cpu", "weight": 1}]}}


def _args_nodes():
    """Three nodes in zone z0, one in z1; n0 has little memory, so
    LeastAllocated over cpu alone ranks it first and over cpu and memory
    last."""
    return [{"metadata": {"name": f"n{i}", "labels": {
                "zone": "z0" if i < 3 else "z1"}},
             "status": {"capacity": {
                 "cpu": "8" if i == 0 else "4",
                 "memory": "4Gi" if i == 0 else "64Gi",
                 "pods": "110"}}} for i in range(4)]


def _args_pods():
    return [{"metadata": {"name": f"p{i}", "uid": f"u-p{i}",
                          "labels": {"app": "a"}},
             "spec": {"containers": [{"name": "c", "resources": {
                 "requests": {"cpu": "1", "memory": "1Gi"}}}]}}
            for i in range(6)]


def _args_arm(plugin_config, ref, batch, seed=5):
    """The default plugin set with ``plugin_config`` (one worker), the
    pods created before start, the batch path on or off, serialized."""
    config = {"parallelism": 1, "profiles": [
        {"schedulerName": "default-scheduler",
         "pluginConfig": plugin_config}]}
    store = _stores(_args_nodes(), _args_pods(), ref)
    sched = _create(store, config, ref, seed,
                    gates={"TPUBatchScheduler": batch})
    bs = None
    if batch:
        bs = attach_batch_scheduler(sched, max_batch=8, device="cpu",
                                    pipeline=False)
    sched.start()
    try:
        if bs is None:
            serial_pass(sched, ref)
        else:
            from types import SimpleNamespace
            pump(SimpleNamespace(sched=sched, bs=bs, store=store))
        return [store.get_pod("default", f"p{i}").spec.node_name
                for i in range(6)], bs
    finally:
        sched.stop()


@pytest.mark.parametrize("args", (SPREAD_ARGS, CPU_WEIGHT_ARGS),
                         ids=("default-constraints", "least-allocated-cpu"))
def test_plugin_args_the_solve_does_not_read_go_serial(args):
    """A profile with the default plugin set and non-default arguments of
    a solve plugin (``PodTopologySpread.defaultConstraints``,
    ``NodeResourcesLeastAllocated``'s resource weights): the solve, which
    computes each plugin with its defaults, would place its pods
    otherwise, so they go serial and bind as the JAX serial arm binds
    them."""
    want, _ = _args_arm([args], ref=True, batch=False)
    got, bs = _args_arm([args], ref=False, batch=True)
    assert got == want and all(want)
    assert bs.batchable_profiles == {"default-scheduler": False}
    assert bs.session.backend.solves == 0
    # the arguments matter: without them the same pods land elsewhere
    plain, _ = _args_arm([], ref=False, batch=False)
    assert plain != want


def test_coscheduling_args_still_batch():
    """Coscheduling's arguments (its Permit wait and gang backoff) are
    honoured by the batch path, which runs the plugin itself."""
    sched = Scheduler.create(
        ClusterStore(), provider="GangSchedulingProvider",
        config={"profiles": [{"schedulerName": "default-scheduler",
                              "pluginConfig": [{"name": "Coscheduling",
                                                "args": {
                                                    "permitWaitSeconds": 3}}]
                              }]})
    assert sched.framework.plugin_args["Coscheduling"] == {
        "permitWaitSeconds": 3}
    assert batchable_profile(sched.framework, sched.feature_gates)


def test_attach_needs_the_gate():
    sched = Scheduler.create(ClusterStore())
    assert attach_batch_scheduler(sched, device="cpu") is None
    assert sched.batch_scheduler is None


def test_run_workload_takes_a_configuration():
    """``run_workload(config=)``: two profiles from a v1beta1 dict; the
    default profile's pods batch."""
    ops = workloads.make_workload("SchedulingBasic", 40, 0, 120)
    res = perf.run_workload("SchedulingBasic", ops, device="cpu",
                            max_batch=64, config=TWO_PROFILES)
    assert all(res.placements.values()) and res.solves > 0
