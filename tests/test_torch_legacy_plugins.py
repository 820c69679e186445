"""The legacy plugins a Policy reaches (NodeLabel, ServiceAffinity,
RequestedToCapacityRatio) against the JAX package's, on seeded small
clusters (numpy draws, manifest dicts read by both packages): nodes with
and without the labels the args name, Services selecting placed pods.
For every pending pod and node, each plugin's Filter status and raw and
normalized Score; then a serial pass of a profile that runs them, with
the same seeded tie draws on both sides. Tolerance: exact equality."""

import copy
import random

import numpy as np
import pytest

from kubernetes_tpu.api.types import Node as JaxNode, ObjectMeta as JaxMeta
from kubernetes_tpu.api.types import Pod as JaxPod, Service as JaxService
from kubernetes_tpu.apiserver.store import ClusterStore as JaxStore
from kubernetes_tpu.config.types import (
    KubeSchedulerConfiguration as JaxConfig,
)
from kubernetes_tpu.scheduler.framework import interface as jax_fw
from kubernetes_tpu.scheduler.framework.cycle_state import (
    CycleState as JaxCycleState,
)
from kubernetes_tpu.scheduler.scheduler import Scheduler as JaxScheduler
from kubernetes_tpu_torch.api.types import Node, ObjectMeta, Pod, Service
from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.config.types import KubeSchedulerConfiguration
from kubernetes_tpu_torch.scheduler.framework import interface as fw
from kubernetes_tpu_torch.scheduler.framework.cycle_state import CycleState
from kubernetes_tpu_torch.scheduler.scheduler import Scheduler
from test_torch_framework import node_dicts, pending_dicts, pod_dict
from test_torch_serial import outcome, serial_pass

SEEDS = (0, 1, 2, 3, 4, 5)
LABELS = ("rack", "ssd", "spot", "retired")
PLUGINS = ("NodeLabel", "ServiceAffinity", "RequestedToCapacityRatio")


def legacy_nodes(rng, n):
    """Node dicts, each label of ``LABELS`` on a seeded share of them
    (rack with one of three values)."""
    nodes = node_dicts(rng, n)
    for d in nodes:
        labels = d["metadata"]["labels"]
        if rng.random() < 0.75:
            labels["rack"] = f"r{int(rng.integers(3))}"
        for key, p in (("ssd", 0.5), ("spot", 0.3), ("retired", 0.1)):
            if rng.random() < p:
                labels[key] = "true"
    return nodes


def legacy_config(rng) -> dict:
    """A v1beta1 profile running the three legacy plugins at seeded
    weights, with seeded args."""
    def some():
        return [str(k) for k in LABELS if rng.random() < 0.4]

    return {
        "parallelism": 1,
        "profiles": [{
            "schedulerName": "default-scheduler",
            "plugins": {
                "preFilter": {"enabled": [{"name": "ServiceAffinity"}]},
                "filter": {"enabled": [{"name": "NodeLabel"},
                                       {"name": "ServiceAffinity"}]},
                "score": {"enabled": [
                    {"name": "NodeLabel", "weight": int(rng.integers(1, 4))},
                    {"name": "ServiceAffinity",
                     "weight": int(rng.integers(1, 4))},
                    {"name": "RequestedToCapacityRatio",
                     "weight": int(rng.integers(1, 4))}]}},
            "pluginConfig": [
                {"name": "NodeLabel", "args": {
                    "presentLabels": ["rack"] if rng.random() < 0.5 else [],
                    "absentLabels": ["retired"],
                    "presentLabelsPreference": some(),
                    "absentLabelsPreference": some()}},
                {"name": "ServiceAffinity", "args": {
                    "affinityLabels": ["rack"] if rng.random() < 0.7 else [],
                    "antiAffinityLabelsPreference": ["rack"]}},
                {"name": "RequestedToCapacityRatio", "args": {
                    "shape": [{"utilization": 0, "score": 10},
                              {"utilization": int(rng.integers(20, 80)),
                               "score": int(rng.integers(0, 10))},
                              {"utilization": 100, "score": 0}],
                    "resources": [{"name": "cpu", "weight": 2},
                                  {"name": "memory", "weight": 1}]}}]}]}


def legacy_cluster(seed, n_nodes=16, n_existing=24):
    rng = np.random.default_rng(seed)
    nodes = legacy_nodes(rng, n_nodes)
    existing = [pod_dict(rng, f"e{i}", node=f"n{int(rng.integers(n_nodes))}",
                         features=0.3) for i in range(n_existing)]
    services = [("svc-a0", {"app": "a0"}), ("svc-a1", {"app": "a1"}),
                ("empty", {})]
    return nodes, existing, services, legacy_config(rng)


def build(seed, ref: bool):
    nodes, existing, services, config = legacy_cluster(seed)
    if ref:
        store = JaxStore()
        for d in nodes:
            store.add_node(JaxNode.from_dict(copy.deepcopy(d)))
        for d in existing:
            store.create_pod(JaxPod.from_dict(copy.deepcopy(d)))
        for name, sel in services:
            store.add_service(JaxService(metadata=JaxMeta(
                name=name, namespace="default"), selector=dict(sel)))
        sched = JaxScheduler.create(store, config=JaxConfig.from_dict(config))
    else:
        store = ClusterStore()
        for d in nodes:
            store.add_node(Node.from_dict(copy.deepcopy(d)))
        store.create_pods([Pod.from_dict(copy.deepcopy(d))
                           for d in existing])
        for name, sel in services:
            store.add_service(Service(metadata=ObjectMeta(
                name=name, namespace="default"), selector=dict(sel)))
        sched = Scheduler.create(store,
                                 config=KubeSchedulerConfiguration.from_dict(
                                     config),
                                 rng=random.Random(seed))
    sched.start()
    return sched


def _status(s):
    return (0, []) if s is None else (s.code, list(s.reasons))


@pytest.mark.parametrize("seed", SEEDS)
def test_filters_and_scores_equal_the_reference(seed):
    ref, port = build(seed, True), build(seed, False)
    try:
        ref.algorithm.update_snapshot()
        port.update_snapshot()
        rfw, pfw = ref.profiles["default-scheduler"], port.framework
        rnis, pnis = ref.algorithm.snapshot.list(), port.snapshot.list()
        names = [ni.node.name for ni in pnis]
        assert names == [ni.node.name for ni in rnis]
        failed = passed = 0
        for d in pending_dicts(seed, 20):
            rpod, ppod = JaxPod.from_dict(copy.deepcopy(d)), Pod.from_dict(d)
            rstate, pstate = JaxCycleState(), CycleState()
            assert _status(pfw.run_pre_filter_plugins(pstate, ppod)) == \
                _status(rfw.run_pre_filter_plugins(rstate, rpod))
            for name in ("NodeLabel", "ServiceAffinity"):
                rp, pp = rfw.get_plugin(name), pfw.get_plugin(name)
                for rni, pni in zip(rnis, pnis):
                    got = _status(pp.filter(pstate, ppod, pni))
                    assert got == _status(rp.filter(rstate, rpod, rni)), (
                        seed, d["metadata"]["name"], name, pni.node.name)
                    failed += got[0] != 0
                    passed += got[0] == 0
            for name in PLUGINS:
                rp, pp = rfw.get_plugin(name), pfw.get_plugin(name)
                raw_ref = [jax_fw.NodeScore(n, rp.score(rstate, rpod, n)[0])
                           for n in names]
                raw_port = [fw.NodeScore(n, pp.score(pstate, ppod, n)[0])
                            for n in names]
                assert [s.score for s in raw_port] == \
                    [s.score for s in raw_ref], (seed, name)
                for plugin, state, pod, scores in (
                        (rp, rstate, rpod, raw_ref),
                        (pp, pstate, ppod, raw_port)):
                    ext = plugin.score_extensions()
                    if ext is not None:
                        ext.normalize_score(state, pod, scores)
                assert [s.score for s in raw_port] == \
                    [s.score for s in raw_ref], (seed, name)
        assert failed and passed
    finally:
        ref.stop()
        port.stop()


@pytest.mark.parametrize("seed", SEEDS)
def test_serial_pass_equals_the_reference(seed):
    pending = pending_dicts(seed, 30)
    results = []
    for ref in (False, True):
        sched = build(seed, ref)
        if ref:
            random.seed(seed)
            sched.client.create_pods([JaxPod.from_dict(copy.deepcopy(d))
                                      for d in pending])
        else:
            sched.client.create_pods([Pod.from_dict(copy.deepcopy(d))
                                      for d in pending])
        try:
            serial_pass(sched, ref)
            results.append(outcome(sched.client,
                                   [d["metadata"]["name"] for d in pending]))
        finally:
            sched.stop()
    got, want = results
    assert got == want
    assert any(node for node, _, _ in got.values())


def test_service_affinity_pins_the_services_rack():
    """A pod of a Service whose placed pods sit on rack r1 passes only the
    r1 nodes (ServiceAffinity's first placed pod fixes the label)."""
    store = ClusterStore()
    for i, rack in enumerate(("r0", "r1", "r1", "r2")):
        store.add_node(Node.from_dict({
            "metadata": {"name": f"n{i}", "labels": {"rack": rack}},
            "status": {"capacity": {"cpu": "8", "memory": "8Gi",
                                    "pods": "10"}}}))
    store.create_pods([Pod.from_dict({
        "metadata": {"name": "web-0", "labels": {"app": "web"}},
        "spec": {"nodeName": "n1", "containers": [{"name": "c"}]}})])
    store.add_service(Service(metadata=ObjectMeta(name="web",
                                                  namespace="default"),
                              selector={"app": "web"}))
    sched = Scheduler.create(store, config={
        "parallelism": 1,
        "profiles": [{"plugins": {
            "preFilter": {"enabled": [{"name": "ServiceAffinity"}]},
            "filter": {"enabled": [{"name": "ServiceAffinity"}]}},
            "pluginConfig": [{"name": "ServiceAffinity",
                              "args": {"affinityLabels": ["rack"]}}]}]})
    sched.start()
    try:
        pod = Pod.from_dict({"metadata": {"name": "web-1",
                                          "labels": {"app": "web"}},
                             "spec": {"containers": [{"name": "c"}]}})
        sched.update_snapshot()
        state = CycleState()
        fwk = sched.framework
        assert fwk.run_pre_filter_plugins(state, pod) is None
        ok = [ni.node.name for ni in sched.snapshot.list()
              if fwk.run_filter_plugins(state, pod, ni) is None]
        assert sorted(ok) == ["n1", "n2"]
    finally:
        sched.stop()
