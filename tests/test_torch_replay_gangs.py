"""The gang fields of traces and replay in the port against the JAX
package: seeded traces with gangs through both ``generate_trace`` and
``build_federation_trace``, their dict round trip and ``events_to_pods``
(identical events and labels); and the replay engine's gang counters,
mesh adjacency and priority inversions over the same stores and the same
bind record. Tolerance: exact equality."""

import random

import pytest

from kubernetes_tpu.api.types import Node as JaxNode, Pod as JaxPod
from kubernetes_tpu.apiserver.store import ClusterStore as JaxStore
from kubernetes_tpu.harness import federation as jax_fed_harness
from kubernetes_tpu.scheduler.types import (
    compute_pod_resource_request as jax_request,
)
from kubernetes_tpu.workloads import replay as jax_replay
from kubernetes_tpu.workloads import trace as jax_trace
from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.harness import federation as fed_harness
from kubernetes_tpu_torch.scheduler.framework.plugins.mesh_locality import (
    mesh_node_labels,
)
from kubernetes_tpu_torch.scheduler.types import (
    compute_pod_resource_request as port_request,
)
from kubernetes_tpu_torch.workloads import replay, trace

PRIORITIES = ((0.5, 0), (0.3, 10), (0.2, 100))


def _traces(seed, pods=160):
    """(port, JAX) federation traces, priorities mixed in."""
    def build(mod, fed):
        base = mod.generate_trace(seed, pods, 2.0, priorities=PRIORITIES,
                                  family="gangs")
        folded = fed.build_federation_trace(seed, pods, 400.0, namespaces=5,
                                            gang_every=3, gang_size=4)
        # the federation trace with the first trace's priorities and
        # lifetimes, so every field is exercised
        from dataclasses import replace

        return [replace(e, priority=b.priority, lifetime_s=b.lifetime_s)
                for e, b in zip(folded.events, base.events)], base
    return build(trace, fed_harness), build(jax_trace, jax_fed_harness)


def _pod_view(pod, request):
    req = request(pod)
    return (pod.metadata.name, pod.metadata.namespace, pod.metadata.uid,
            dict(pod.metadata.labels), pod.spec.priority, req.milli_cpu,
            req.memory)


@pytest.mark.parametrize("seed", [0, 5, 18])
def test_gang_trace_round_trip_and_pods_match_reference(seed):
    (got, got_base), (want, want_base) = _traces(seed)
    assert [e.to_dict() for e in got_base.events] \
        == [e.to_dict() for e in want_base.events]
    got_d = [e.to_dict() for e in got]
    assert got_d == [e.to_dict() for e in want]
    assert any(e.gang for e in got) and any(e.priority for e in got)
    # the dict round trip, and the reference's dicts read by the port
    assert [trace.TraceEvent.from_dict(d) for d in got_d] == got
    assert [trace.TraceEvent.from_dict(e.to_dict()).to_dict()
            for e in want] == got_d
    got_pods = [_pod_view(p, port_request)
                for p in trace.events_to_pods(got)]
    want_pods = [_pod_view(p, jax_request)
                 for p in jax_trace.events_to_pods(want)]
    assert got_pods == want_pods
    gang = next(p for p in got_pods if p[3])
    assert set(gang[3]) == {"pod-group.scheduling.k8s.io/name",
                            "pod-group.scheduling.k8s.io/min-available"}


def _engine(mod, Store, NodeT, PodT, events, seed, cols=4):
    """A replay engine (not started) over a store of mesh-labelled nodes
    holding the trace's pods, a seeded part of them bound, and the
    matching bind record."""
    rng = random.Random(seed)
    store = Store()
    n_nodes = 12
    for i in range(n_nodes):
        store.add_node(NodeT.from_dict({
            "metadata": {"name": f"n{i}", "labels": {
                "kubernetes.io/hostname": f"n{i}",
                **mesh_node_labels(i, cols)}},
            "status": {"capacity": {"cpu": "2", "memory": "4Gi",
                                    "pods": "110"}}}))
    tr = (jax_trace if mod is jax_replay else trace).Trace(
        events=list(events), family="gangs", seed=seed, duration_s=1.0)
    engine = mod.ReplayEngine(store, tr, expire=False)
    pods, bind = [], {}
    for e in events:
        pod = PodT.from_dict(e.pod_dict())
        pod.metadata.uid = f"rp-{e.name}"
        if rng.random() < 0.6:
            pod.spec.node_name = f"n{rng.randrange(n_nodes)}"
            bind[e.name] = (e.t + 0.01, pod.spec.node_name)
        pods.append(pod)
    store.create_pods(pods)
    engine._bind = dict(bind)
    return engine, store, bind


@pytest.mark.parametrize("seed", [0, 5, 18])
def test_replay_gang_counters_match_reference(seed):
    (got_events, _), (want_events, _) = _traces(seed, pods=80)
    out = []
    for mod, Store, NodeT, PodT, events in (
            (replay, ClusterStore, Node, Pod, got_events),
            (jax_replay, JaxStore, JaxNode, JaxPod, want_events)):
        engine, store, bind = _engine(mod, Store, NodeT, PodT, events, seed)
        live = {p.metadata.name: p for p in store.list_pods()}
        out.append((engine._gang_integrity(bind), engine._adjacency(bind),
                    engine._priority_inversions(live)))
    assert out[0] == out[1]
    (total, placed, partial), adjacency, inversions = out[0]
    assert total > 0 and partial > 0 and adjacency is not None
    assert inversions > 0


def test_replay_stats_carry_the_gang_counters():
    """A gang trace replayed against a store with no scheduler: nothing
    binds, so every gang is unplaced and none partial; then bind one
    member of one gang by hand: that gang is partial."""
    tr = fed_harness.build_federation_trace(3, 40, 2000.0, namespaces=2,
                                            gang_every=2, gang_size=4)
    store = ClusterStore()
    store.add_node(Node.from_dict({
        "metadata": {"name": "n0"},
        "status": {"capacity": {"cpu": "1", "memory": "1Gi",
                                "pods": "110"}}}))
    engine = replay.ReplayEngine(store, tr, time_scale=0.0, expire=False)
    engine.start()
    assert engine.injection_done.wait(10.0)
    gang_member = next(e for e in tr.events if e.gang)
    store.bind(gang_member.namespace, gang_member.name,
               f"rp-{gang_member.name}", "n0")
    stats = engine.finish()
    assert stats.injected == 40 and stats.lost == 0
    assert stats.gangs_total == 5 and stats.gangs_placed == 0
    assert stats.gangs_partial == 1 and not stats.gangs_intact
    assert stats.mean_gang_adjacency is None
