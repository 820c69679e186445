"""The port's scheduling queue, cache and store against the JAX
package's, fed the same operations: the same pods popped in the same
order with the same cycles and attempts; the same mutation counts,
assume verdicts and snapshot contents (the solver session's validity
check and the encoder's node order rest on these); the same bind
verdicts, with the port's bind events reaching its cache and queue."""

import numpy as np
import pytest

from kubernetes_tpu.api.types import Node as JaxNode, Pod as JaxPod
from kubernetes_tpu.apiserver.store import ClusterStore as JaxStore
from kubernetes_tpu.scheduler.cache import SchedulerCache as JaxCache
from kubernetes_tpu.scheduler.framework.plugins.queue_sort import PrioritySort
from kubernetes_tpu.scheduler.queue import SchedulingQueue as JaxQueue
from kubernetes_tpu.scheduler.snapshot import Snapshot as JaxSnapshot
from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.scheduler.cache import SchedulerCache
from kubernetes_tpu_torch.scheduler.queue import SchedulingQueue
from kubernetes_tpu_torch.scheduler.scheduler import Scheduler
from kubernetes_tpu_torch.scheduler.snapshot import Snapshot
from test_torch_cases import mixed_cluster, node, pod


class Clock:
    def __init__(self):
        self.t = 100.0

    def now(self):
        return self.t


def _queues():
    clock = Clock()
    ref = JaxQueue(clock=clock)
    # what the reference scheduler wires from its PrioritySort profile
    ref.sort_key = PrioritySort.sort_key
    ref._active_q.set_sort_key(ref.sort_key)
    port = SchedulingQueue()
    port._now = clock.now
    return clock, ref, port


def _burst(rng, prefix, n):
    return [pod(f"{prefix}{i}", priority=int(rng.choice([0, 10, 100])))
            for i in range(n)]


@pytest.mark.parametrize("seed", [0, 1])
def test_queue_order_matches_reference(seed):
    rng = np.random.default_rng(seed)
    clock, ref, port = _queues()
    popped = {}

    def add(dicts):
        ref.add_many([JaxPod.from_dict(d) for d in dicts])
        port.add_many([Pod.from_dict(d) for d in dicts])

    def pop(n):
        a, ca = ref.pop_batch(n, timeout=0)
        b, cb = port.pop_batch(n, timeout=0)
        assert [q.pod.name for q in b] == [q.pod.name for q in a]
        assert [q.attempts for q in b] == [q.attempts for q in a]
        assert cb == ca
        for i, (qa, qb) in enumerate(zip(a, b)):
            popped[qa.pod.name] = (qa, qb, ca + i)
        assert port.pending_active_count() == ref.pending_active_count()
        return [q.pod.name for q in a]

    def requeue(names):
        for name in names:
            qa, qb, cycle = popped.pop(name)
            ref.add_unschedulable_if_not_present(qa, cycle)
            port.add_unschedulable_if_not_present(qb, cycle)

    # one bulk add: every pod has the same timestamp, so equal priorities
    # keep the heap's own order
    add(_burst(rng, "a", 60))
    clock.t += 1.0
    add(_burst(rng, "b", 30))
    first = pop(25)
    requeue(first[::2])                  # parked: no move request yet
    ref.move_all_to_active_or_backoff_queue("test")
    port.move_all_to_active_or_backoff_queue("test")   # -> backoff (1 s)
    second = pop(20)
    requeue(second[1::3])                # a move came in: straight to backoff
    clock.t += 0.5
    add(_burst(rng, "c", 10))
    pop(7)
    clock.t += 2.5                       # every backoff (1 s, 2 s) done
    ref.flush_backoff_completed()
    port.flush_backoff_completed()
    pop(1000)
    assert port.pending_active_count() == ref.pending_active_count() == 0


def _node_state(snapshot):
    return [(ni.node.name, ni.requested.milli_cpu, ni.requested.memory,
             ni.non_zero_requested.milli_cpu, len(ni.pods))
            for ni in snapshot.list()]


def test_cache_mutations_and_snapshot_match_reference():
    nodes, existing = mixed_cluster(8)
    ref, port = JaxCache(), SchedulerCache()

    def both(method, dicts, many=False):
        if many:
            a = getattr(ref, method)([JaxPod.from_dict(d) for d in dicts])
            b = getattr(port, method)([Pod.from_dict(d) for d in dicts])
        else:
            a = getattr(ref, method)(JaxPod.from_dict(dicts))
            b = getattr(port, method)(Pod.from_dict(dicts))
        assert (port.mutation_seq, port.node_set_seq) == (
            ref.mutation_seq, ref.node_set_seq), method
        return a, b

    for d in nodes:
        ref.add_node(JaxNode.from_dict(d))
        port.add_node(Node.from_dict(d))
    assert (port.mutation_seq, port.node_set_seq) == (ref.mutation_seq,
                                                      ref.node_set_seq)
    for d in existing:
        both("add_pod", d)
    placed = [pod(f"s{i}", cpu="1", node_name=f"node-{i % 3}")
              for i in range(6)]
    for d in placed[:4]:
        both("assume_pod", d)
    both("finish_binding", placed[0])
    # an assume of a pod already in the cache is refused, per pod
    a, b = both("assume_pods", placed[3:], many=True)
    assert b == a and a[0] is not None and a[1:] == [None, None]
    # confirmed where assumed: no mutation; confirmed elsewhere: a move
    moved = dict(placed[1], spec=dict(placed[1]["spec"], nodeName="node-5"))
    both("add_pods", [placed[0], moved], many=True)
    both("forget_pod", placed[2])
    for d in placed:
        assert port.is_assumed_pod(Pod.from_dict(d)) == ref.is_assumed_pod(
            JaxPod.from_dict(d))
    # a known node again: a mutation, not a new node
    relabeled = node(3, labels={"disk": "hdd"})
    ref.add_node(JaxNode.from_dict(relabeled))
    port.add_node(Node.from_dict(relabeled))
    assert (port.mutation_seq, port.node_set_seq) == (ref.mutation_seq,
                                                      ref.node_set_seq)

    ref_snap, port_snap = JaxSnapshot(), Snapshot()
    ref.update_snapshot(ref_snap)
    port.update_snapshot(port_snap)
    assert _node_state(port_snap) == _node_state(ref_snap)
    assert [ni.node.name for ni in
            port_snap.have_pods_with_required_anti_affinity_list()] == [
        ni.node.name for ni in
        ref_snap.have_pods_with_required_anti_affinity_list()]


def test_store_bind_matches_reference_and_feeds_cache_and_queue():
    nodes, _ = mixed_cluster(4)
    pods = [pod(f"q{i}") for i in range(5)]
    ref, port = JaxStore(), ClusterStore()
    sched = Scheduler(port)
    sched.start()
    for d in nodes:
        ref.add_node(JaxNode.from_dict(d))
        port.add_node(Node.from_dict(d))
    ref.create_pods([JaxPod.from_dict(d) for d in pods])
    port.create_pods([Pod.from_dict(d) for d in pods])
    assert sched.queue.pending_active_count() == 5
    seq = sched.cache.mutation_seq

    binds = [("q0", "uid-q0", "node-1"),      # binds
             ("q0", "uid-q0", "node-1"),      # again, same node: allowed
             ("q0", "uid-q0", "node-2"),      # bound elsewhere
             ("q1", "uid-other", "node-1"),   # uid mismatch
             ("gone", "", "node-1"),          # no such pod
             ("q2", "", "node-3")]            # no uid given: binds
    for name, uid, node_name in binds:
        verdicts = []
        for store in (ref, port):
            try:
                store.bind("default", name, uid, node_name)
                verdicts.append(None)
            except (KeyError, ValueError) as e:
                verdicts.append(type(e))
        assert verdicts[1] == verdicts[0], (name, uid, node_name)
    assert {p.name: p.spec.node_name for p in port.list_pods()} == {
        p.name: p.spec.node_name for p in ref.list_pods()}
    # the bind events reached the scheduler: two pods left the queue and
    # entered the cache
    assert sched.queue.pending_active_count() == 3
    assert sched.cache.mutation_seq == seq + 2
    sched.stop()
