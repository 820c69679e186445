"""The whole batch path on both sides: store -> queue -> cache and snapshot
-> encoder -> planes -> solve -> commit and bind, run by each package's
``run_workload`` on the same workload. Every pod is bound and the pod ->
node maps are identical.

The maps can be compared pod by pod: pods admitted in one bulk create
are enqueued with strictly increasing monotonic timestamps, so both
queues drain them in creation order, and both sides order node columns
the same zone-interleaved way."""

import pytest

from kubernetes_tpu.harness import perf as jax_perf
from kubernetes_tpu.harness import workloads as jax_workloads
from kubernetes_tpu.ops.pallas_solver import XlaPlanesBackend
from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.harness import perf, workloads
from kubernetes_tpu_torch.scheduler.scheduler import Scheduler
from kubernetes_tpu_torch.sidecar import BatchScheduler


def _jax_placements(name, nodes, pods):
    placed = {}

    def hook(sched, _bs):
        placed.update({p.metadata.name: p.spec.node_name
                       for p in sched.client.list_pods()})

    jax_perf.run_workload(
        name, jax_workloads.make_workload(name, nodes, 0, pods),
        use_batch=True, backend_factory=XlaPlanesBackend,
        adaptive_chunk=False, max_batch=128, result_hook=hook)
    return placed


@pytest.mark.parametrize("name,nodes,pods", [
    ("SchedulingBasic", 200, 1000),
    ("TopologySpreading", 200, 600),
])
def test_slice_matches_reference(name, nodes, pods):
    res = perf.run_workload(name, workloads.make_workload(name, nodes, 0,
                                                          pods),
                            device="cpu", max_batch=128)
    want = _jax_placements(name, nodes, pods)
    assert len(res.placements) == pods
    assert all(res.placements.values()), "a pod was left unbound"
    assert res.placements == want
    # the port's backend did the solves, batch after batch on the carried
    # state
    assert res.solves >= pods // 128
    assert res.pods_per_second > 0
    assert set(res.latency) == {"Perc50", "Perc90", "Perc99"}


def test_session_carries_state_until_an_outside_mutation():
    """Batches after the first ride the carried device state (pod-side
    encode only) while the cache saw only the batch path's own assumes;
    a new node makes the next solve re-encode the cluster."""
    store = ClusterStore()
    sched = Scheduler(store)
    bs = BatchScheduler(sched, max_batch=8, device="cpu")
    sched.start()
    for i in range(4):
        store.add_node(Node.from_dict(workloads.node_template(i)))
    store.create_pods([Pod.from_dict(workloads.basic_pod(i))
                       for i in range(20)])
    session = bs.session
    while bs.run_batch(pop_timeout=0.0):
        assert session.mirror_current()
    assert (session.rebuilds, session.incremental_hits) == (1, 2)
    store.add_node(Node.from_dict(workloads.node_template(4)))
    assert not session.mirror_current()
    store.create_pods([Pod.from_dict(workloads.basic_pod(i))
                       for i in range(20, 24)])
    bs.run_batch(pop_timeout=0.0)
    assert session.rebuilds == 2 and session.mirror_current()
    assert all(p.spec.node_name for p in store.list_pods())
    # the unschedulable path: a pod no node fits goes back to the queue
    session.invalidate()
    assert not session.mirror_current()
    big = workloads.basic_pod(99, cpu="64")
    store.create_pods([Pod.from_dict(big)])
    bs.run_batch(pop_timeout=0.0)
    assert sched.queue.pending_active_count() == 0
    assert not [p for p in store.list_pods() if p.name == "pod-99"
                and p.spec.node_name]


def test_topology_spread_skew_within_one():
    res = perf.run_workload(
        "TopologySpreading",
        workloads.make_workload("TopologySpreading", 40, 0, 200),
        device="cpu", max_batch=64)
    per_zone = {}
    for node in res.placements.values():
        zone = int(node.split("-")[1]) % 10
        per_zone[zone] = per_zone.get(zone, 0) + 1
    assert sum(per_zone.values()) == 200
    assert max(per_zone.values()) - min(per_zone.values()) <= 1


def test_anti_affinity_row_matches_reference():
    """BASELINE config 4's row cut to 200 nodes / 50 / 400: 100 colours,
    each measured pod with a required hostname anti-affinity to its own
    colour (T = 100 tracked terms). Same node per pod as the JAX harness,
    and no node holds two measured pods of one colour."""
    name, nodes, init, pods = "SchedulingPodAntiAffinity", 200, 50, 400
    res = perf.run_workload(name, workloads.make_workload(name, nodes, init,
                                                          pods),
                            device="cpu", max_batch=128)
    placed = {}

    def hook(sched, _bs):
        placed.update({p.metadata.name: p.spec.node_name
                       for p in sched.client.list_pods()})

    jax_perf.run_workload(
        name, jax_workloads.make_workload(name, nodes, init, pods),
        use_batch=True, backend_factory=XlaPlanesBackend,
        adaptive_chunk=False, max_batch=128, result_hook=hook)
    assert len(res.placements) == init + pods
    assert all(res.placements.values())
    assert res.placements == placed
    seen = set()
    for i in range(init, init + pods):
        key = (res.placements[f"pod-{i}"], i % 100)
        assert key not in seen, key
        seen.add(key)
