"""The port's framework and plugins against the JAX package's, on the same
seeded small clusters (numpy draws, manifest dicts read by both
packages): for every ported plugin and every (pod, node) pair, the
Filter status code and reasons; for every score plugin, the raw and the
normalized scores; the whole filter chain with nominated pods; the
``FitError`` message. Tolerance: exact equality throughout.

The JAX scheduler is built with ``parallelism=1`` (its filters then run
in node order, as the port's do). ``cluster_dicts`` and ``pending_dicts``
are shared with the serial and preemption tests."""

import copy
import random

import numpy as np
import pytest

from kubernetes_tpu.api.types import Node as JaxNode, Pod as JaxPod
from kubernetes_tpu.apiserver.store import ClusterStore as JaxStore
from kubernetes_tpu.config.types import KubeSchedulerConfiguration
from kubernetes_tpu.scheduler.framework import interface as jax_fw
from kubernetes_tpu.scheduler.framework.cycle_state import (
    CycleState as JaxCycleState,
)
from kubernetes_tpu.scheduler.scheduler import Scheduler as JaxScheduler
from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.scheduler.framework import interface as fw
from kubernetes_tpu_torch.scheduler.framework.cycle_state import CycleState
from kubernetes_tpu_torch.scheduler.scheduler import (
    Scheduler,
    SchedulerConfiguration,
)

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
BIG_IMAGE = "registry/big:1"
SEEDS = (0, 1, 2, 3, 4)

FILTER_PLUGINS = ("NodeUnschedulable", "NodeName", "TaintToleration",
                  "NodeAffinity", "NodePorts", "NodeResourcesFit",
                  "PodTopologySpread", "InterPodAffinity")
SCORE_PLUGINS = ("NodeResourcesBalancedAllocation", "ImageLocality",
                 "InterPodAffinity", "NodeResourcesLeastAllocated",
                 "NodeAffinity", "NodePreferAvoidPods", "PodTopologySpread",
                 "TaintToleration", "SelectorSpread")


def node_dicts(rng, n):
    nodes = []
    for i in range(n):
        labels = {HOST: f"n{i}", ZONE: f"z{i % 3}"}
        if rng.random() < 0.5:
            labels["disk"] = "ssd"
        if rng.random() < 0.1:
            del labels[ZONE]
        taints = []
        r = rng.random()
        if r < 0.15:
            taints.append({"key": "dedicated", "value": "gpu",
                           "effect": "NoSchedule"})
        elif r < 0.35:
            taints.append({"key": "spot", "value": "true",
                           "effect": "PreferNoSchedule"})
        spec = {"taints": taints}
        if rng.random() < 0.08:
            spec["unschedulable"] = True
        images = ([{"names": [BIG_IMAGE], "sizeBytes": 600 * 1024 * 1024}]
                  if rng.random() < 0.4 else [])
        nodes.append({
            "metadata": {"name": f"n{i}", "labels": labels},
            "spec": spec,
            "status": {"capacity": {
                "cpu": str(int(rng.choice([2, 4, 8]))),
                "memory": f"{int(rng.choice([4, 8, 16]))}Gi",
                "pods": "12"}, "images": images}})
    return nodes


def _term(rng, app):
    return {"labelSelector": {"matchLabels": {"app": app}},
            "topologyKey": str(rng.choice([ZONE, HOST]))}


def pod_dict(rng, name, node="", features=1.0, priority=None):
    """A pod with a seeded mix of requests, images, selectors, node and
    pod (anti-)affinity, tolerations, spread constraints and host ports;
    ``features`` scales how often each appears."""
    app = f"a{int(rng.integers(3))}"
    other = f"a{int(rng.integers(3))}"
    spec = {"containers": [{
        "name": "c", "image": str(rng.choice([BIG_IMAGE, "registry/s:1"])),
        "resources": {"requests": {
            "cpu": f"{int(rng.choice([100, 250, 500, 1000]))}m",
            "memory": f"{int(rng.choice([128, 256, 512]))}Mi"}}}]}
    if node:
        spec["nodeName"] = node
    if priority is not None:
        spec["priority"] = priority

    def maybe(p):
        return rng.random() < p * features

    if maybe(0.15):
        spec["nodeSelector"] = {"disk": "ssd"}
    affinity = {}
    if maybe(0.15):
        affinity["nodeAffinity"] = {
            "requiredDuringSchedulingIgnoredDuringExecution": {
                "nodeSelectorTerms": [{"matchExpressions": [{
                    "key": ZONE, "operator": "In",
                    "values": ["z0", "z1"]}]}]}}
    if maybe(0.2):
        affinity.setdefault("nodeAffinity", {})[
            "preferredDuringSchedulingIgnoredDuringExecution"] = [{
                "weight": int(rng.integers(1, 50)),
                "preference": {"matchExpressions": [{
                    "key": "disk", "operator": "In", "values": ["ssd"]}]}}]
    if maybe(0.15):
        affinity["podAffinity"] = {
            "requiredDuringSchedulingIgnoredDuringExecution": [
                _term(rng, other)]}
    if maybe(0.2):
        affinity.setdefault("podAffinity", {})[
            "preferredDuringSchedulingIgnoredDuringExecution"] = [{
                "weight": int(rng.integers(1, 100)),
                "podAffinityTerm": _term(rng, other)}]
    if maybe(0.15):
        affinity["podAntiAffinity"] = {
            "requiredDuringSchedulingIgnoredDuringExecution": [
                _term(rng, app)]}
    if maybe(0.2):
        affinity.setdefault("podAntiAffinity", {})[
            "preferredDuringSchedulingIgnoredDuringExecution"] = [{
                "weight": int(rng.integers(1, 100)),
                "podAffinityTerm": _term(rng, other)}]
    if affinity:
        spec["affinity"] = affinity
    tolerations = []
    if maybe(0.3):
        tolerations.append({"key": "dedicated", "operator": "Equal",
                            "value": "gpu", "effect": "NoSchedule"})
    if maybe(0.3):
        tolerations.append({"key": "spot", "operator": "Exists"})
    if tolerations:
        spec["tolerations"] = tolerations
    if maybe(0.2):
        spec["topologySpreadConstraints"] = [{
            "maxSkew": int(rng.integers(1, 3)),
            "topologyKey": str(rng.choice([ZONE, HOST])),
            "whenUnsatisfiable": str(rng.choice(["DoNotSchedule",
                                                 "ScheduleAnyway"])),
            "labelSelector": {"matchLabels": {"app": app}}}]
    if maybe(0.1):
        spec["containers"][0]["ports"] = [{
            "containerPort": 80, "hostPort": int(rng.choice([8080, 9090]))}]
    return {"metadata": {"name": name, "uid": f"u-{name}",
                         "labels": {"app": app}}, "spec": spec}


def cluster_dicts(seed, n_nodes=12, n_existing=24):
    """(node dicts, bound pod dicts) of a seeded small cluster."""
    rng = np.random.default_rng(seed)
    nodes = node_dicts(rng, n_nodes)
    existing = [pod_dict(rng, f"e{i}", node=f"n{int(rng.integers(n_nodes))}",
                         features=0.7)
                for i in range(n_existing)]
    return nodes, existing


def pending_dicts(seed, n):
    rng = np.random.default_rng(seed + 1000)
    return [pod_dict(rng, f"p{i}") for i in range(n)]


def jax_scheduler(nodes, existing, **config):
    store = JaxStore()
    for d in nodes:
        store.add_node(JaxNode.from_dict(copy.deepcopy(d)))
    for d in existing:
        store.create_pod(JaxPod.from_dict(copy.deepcopy(d)))
    sched = JaxScheduler.create(
        store, config=KubeSchedulerConfiguration(parallelism=1, **config))
    sched.start()
    return sched


def port_scheduler(nodes, existing, seed=None, **config):
    store = ClusterStore()
    for d in nodes:
        store.add_node(Node.from_dict(copy.deepcopy(d)))
    store.create_pods([Pod.from_dict(copy.deepcopy(d)) for d in existing])
    sched = Scheduler(store, config=SchedulerConfiguration(**config),
                      rng=random.Random(seed))
    sched.start()
    return sched


def both(seed, **kw):
    nodes, existing = cluster_dicts(seed, **kw)
    ref = jax_scheduler(nodes, existing)
    port = port_scheduler(nodes, existing)
    ref.algorithm.update_snapshot()
    port.update_snapshot()
    return ref, port


def _status(s):
    """(code, reasons) of a status of either package; None is Success."""
    return (0, []) if s is None else (s.code, list(s.reasons))


def _node_pairs(ref, port):
    rnis = ref.algorithm.snapshot.list()
    pnis = port.snapshot.list()
    assert [ni.node.name for ni in rnis] == [ni.node.name for ni in pnis]
    return list(zip(rnis, pnis))


@pytest.mark.parametrize("seed", SEEDS)
def test_filter_plugins_equal_the_reference(seed):
    ref, port = both(seed)
    rfw = ref.profiles["default-scheduler"]
    pairs = _node_pairs(ref, port)
    checked = 0
    for d in pending_dicts(seed, 24):
        rpod, ppod = JaxPod.from_dict(copy.deepcopy(d)), Pod.from_dict(d)
        rstate, pstate = JaxCycleState(), CycleState()
        assert _status(rfw.run_pre_filter_plugins(rstate, rpod)) == \
            _status(port.framework.run_pre_filter_plugins(pstate, ppod))
        for name in FILTER_PLUGINS:
            rp, pp = rfw.get_plugin(name), port.framework.get_plugin(name)
            for rni, pni in pairs:
                got = _status(pp.filter(pstate, ppod, pni))
                want = _status(rp.filter(rstate, rpod, rni))
                assert got == want, (seed, d["metadata"]["name"], name,
                                     pni.node.name)
                checked += 1
    assert checked == 24 * len(FILTER_PLUGINS) * len(pairs)


@pytest.mark.parametrize("seed", SEEDS)
def test_score_plugins_equal_the_reference(seed):
    ref, port = both(seed)
    rfw = ref.profiles["default-scheduler"]
    pairs = _node_pairs(ref, port)
    names = [ni.node.name for ni, _ in pairs]
    for d in pending_dicts(seed, 24):
        rpod, ppod = JaxPod.from_dict(copy.deepcopy(d)), Pod.from_dict(d)
        rstate, pstate = JaxCycleState(), CycleState()
        rfw.run_pre_filter_plugins(rstate, rpod)
        port.framework.run_pre_filter_plugins(pstate, ppod)
        assert _status(rfw.run_pre_score_plugins(
            rstate, rpod, [r for r, _ in pairs])) == _status(
            port.framework.run_pre_score_plugins(
                pstate, ppod, [p for _, p in pairs]))
        for name in SCORE_PLUGINS:
            rp, pp = rfw.get_plugin(name), port.framework.get_plugin(name)
            raw_ref = [jax_fw.NodeScore(n, _checked(rp.score(rstate, rpod, n)))
                       for n in names]
            raw_port = [fw.NodeScore(n, _checked(pp.score(pstate, ppod, n)))
                        for n in names]
            assert [s.score for s in raw_port] == \
                [s.score for s in raw_ref], (seed, name)
            for plugin, state, pod, scores in (
                    (rp, rstate, rpod, raw_ref),
                    (pp, pstate, ppod, raw_port)):
                ext = plugin.score_extensions()
                if ext is not None:
                    assert ext.normalize_score(state, pod, scores) is None
            assert [(s.name, s.score) for s in raw_port] == \
                [(s.name, s.score) for s in raw_ref], (seed, name)


def _checked(result):
    score, status = result
    assert status is None
    return score


@pytest.mark.parametrize("seed", SEEDS)
def test_filter_chain_with_nominated_pods_equals_the_reference(seed):
    """Pods nominated to nodes (higher and lower priority than the pod
    filtered) take part in the first of the two filter passes."""
    ref, port = both(seed)
    rfw = ref.profiles["default-scheduler"]
    pairs = _node_pairs(ref, port)
    rng = np.random.default_rng(seed + 7)
    for i in range(6):
        d = pod_dict(rng, f"nom{i}", priority=int(rng.choice([0, 10])))
        d["status"] = {"nominatedNodeName": f"n{int(rng.integers(len(pairs)))}"}
        ref.queue.add(JaxPod.from_dict(copy.deepcopy(d)))
        port.queue.add_many([Pod.from_dict(d)])
    assert any(port.queue.nominated_pods_for_node(ni.node.name)
               for _, ni in pairs)
    for d in pending_dicts(seed, 16):
        d["spec"]["priority"] = 5
        rpod, ppod = JaxPod.from_dict(copy.deepcopy(d)), Pod.from_dict(d)
        rstate, pstate = JaxCycleState(), CycleState()
        rfw.run_pre_filter_plugins(rstate, rpod)
        port.framework.run_pre_filter_plugins(pstate, ppod)
        for rni, pni in pairs:
            want = rfw.run_filter_plugins_with_nominated_pods(rstate, rpod,
                                                              rni)
            got = port.framework.run_filter_plugins_with_nominated_pods(
                pstate, ppod, pni)
            assert _status(got) == _status(want), (seed, pni.node.name)
            assert (got.failed_plugin if got else "") == \
                (want.failed_plugin if want else "")


@pytest.mark.parametrize("seed", SEEDS)
def test_fit_error_message_equals_the_reference(seed):
    """The aggregated message of the statuses the whole chain gives, as
    users read it on the pod's condition."""
    ref, port = both(seed)
    rfw = ref.profiles["default-scheduler"]
    pairs = _node_pairs(ref, port)
    for d in pending_dicts(seed, 16):
        rpod, ppod = JaxPod.from_dict(copy.deepcopy(d)), Pod.from_dict(d)
        rstate, pstate = JaxCycleState(), CycleState()
        rfw.run_pre_filter_plugins(rstate, rpod)
        port.framework.run_pre_filter_plugins(pstate, ppod)
        rst, pst = {}, {}
        for rni, pni in pairs:
            s = rfw.run_filter_plugins(rstate, rpod, rni)
            if s is not None:
                rst[rni.node.name] = s
            s = port.framework.run_filter_plugins(pstate, ppod, pni)
            if s is not None:
                pst[pni.node.name] = s
        assert str(fw.FitError(ppod, len(pairs), pst)) == \
            str(jax_fw.FitError(rpod, len(pairs), rst))


def test_fit_error_aggregation_counts_and_sorts_reasons():
    statuses = {
        "a": fw.Status(fw.UNSCHEDULABLE, "Insufficient cpu"),
        "b": fw.Status(fw.UNSCHEDULABLE, "Insufficient memory",
                       "Insufficient cpu"),
        "c": fw.Status(fw.UNSCHEDULABLE_AND_UNRESOLVABLE,
                       "node(s) didn't match node selector"),
    }
    ref = {k: jax_fw.Status(v.code, *v.reasons) for k, v in statuses.items()}
    msg = str(fw.FitError(None, 4, statuses))
    assert msg == str(jax_fw.FitError(None, 4, ref))
    assert msg == ("0/4 nodes are available: 2 Insufficient cpu, 1 "
                   "Insufficient memory, 1 node(s) didn't match node "
                   "selector.")
    assert str(fw.FitError(None, 0, {})) == "0/0 nodes are available."
