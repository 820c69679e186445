"""The port's pod and node event surface against the JAX package's: the
cache's mutation set (pod update and removal, node update and removal,
assume expiry) bumps the same counters and journals the same kinds in
the same order; the queue's update, delete and drain hint agree; and the
store's new verbs reach the port's cache and queue through the event
handlers."""

import copy

import numpy as np

from kubernetes_tpu.api.types import Node as JaxNode, Pod as JaxPod
from kubernetes_tpu.ops.mirror import DeltaJournal as JaxJournal
from kubernetes_tpu.scheduler.cache import SchedulerCache as JaxCache
from kubernetes_tpu.scheduler.snapshot import Snapshot as JaxSnapshot
from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.ops.mirror import DeltaJournal
from kubernetes_tpu_torch.scheduler import queue as q
from kubernetes_tpu_torch.scheduler.cache import ASSUME_TTL, SchedulerCache
from kubernetes_tpu_torch.scheduler.scheduler import (
    Scheduler,
    commit_target_stale,
)
from kubernetes_tpu_torch.scheduler.snapshot import Snapshot
from test_torch_cases import mixed_cluster, node, pod
from test_torch_sched import _node_state, _queues


def _kinds(journal):
    return [(r.seq, r.kind) for r in journal._recs]


def test_cache_mutations_and_journal_match_reference():
    nodes, existing = mixed_cluster(8)
    ref, port = JaxCache(), SchedulerCache()
    ref_j, port_j = JaxJournal(), DeltaJournal()
    ref.attach_delta_journal(ref_j)
    port.attach_delta_journal(port_j)

    def both(method, *dicts, many=False, kind=(Pod, JaxPod)):
        if many:
            args_p = ([kind[0].from_dict(d) for d in dicts[0]],)
            args_r = ([kind[1].from_dict(d) for d in dicts[0]],)
        else:
            args_p = tuple(kind[0].from_dict(d) for d in dicts)
            args_r = tuple(kind[1].from_dict(d) for d in dicts)
        getattr(port, method)(*args_p)
        getattr(ref, method)(*args_r)
        assert (port.mutation_seq, port.node_set_seq) == (
            ref.mutation_seq, ref.node_set_seq), method
        assert _kinds(port_j) == _kinds(ref_j), method

    nodes_kind = (Node, JaxNode)
    for d in nodes:
        both("add_node", d, kind=nodes_kind)
    for d in existing:
        both("add_pod", d)
    placed = [pod(f"s{i}", cpu="1", node_name=f"node-{i % 3}")
              for i in range(6)]
    both("assume_pod", placed[0])
    both("assume_pods", placed[1:4], many=True)
    # confirmed where assumed: nothing; elsewhere: a move
    moved = copy.deepcopy(placed[2])
    moved["spec"]["nodeName"] = "node-6"
    both("add_pods", [placed[1], moved], many=True)
    # a spec change, then a status-only one (no mutation)
    bigger = copy.deepcopy(placed[1])
    bigger["spec"]["containers"][0]["resources"]["requests"]["cpu"] = "2"
    both("update_pod", placed[1], bigger)
    both("update_pod", bigger, bigger)
    both("remove_pod", bigger)
    both("remove_pod", bigger)                  # gone already: nothing
    both("forget_pod", placed[3])
    # allocatable change, then the same node again (nothing), then labels
    resized = copy.deepcopy(nodes[2])
    resized["status"]["capacity"]["cpu"] = "16"
    both("update_node", nodes[2], resized, kind=nodes_kind)
    both("update_node", resized, resized, kind=nodes_kind)
    relabeled = copy.deepcopy(resized)
    relabeled["metadata"]["labels"]["disk"] = "hdd"
    both("update_node", resized, relabeled, kind=nodes_kind)
    # a node leaves with a pod on it, then that pod leaves
    both("remove_node", nodes[1], kind=nodes_kind)
    both("remove_pod", existing[0])
    both("add_node", nodes[1], kind=nodes_kind)    # back: a new node
    # assume expiry: only the assumed pod whose bind was sent expires
    both("assume_pod", placed[4])
    both("assume_pod", placed[5])
    port.finish_binding(Pod.from_dict(placed[4]), now=100.0)
    ref.finish_binding(JaxPod.from_dict(placed[4]), now=100.0)
    port.cleanup_expired_assumed_pods(now=100.0 + ASSUME_TTL - 1)
    ref.cleanup_expired_assumed_pods(now=100.0 + ASSUME_TTL - 1)
    assert _kinds(port_j) == _kinds(ref_j)
    port.cleanup_expired_assumed_pods(now=100.0 + ASSUME_TTL)
    ref.cleanup_expired_assumed_pods(now=100.0 + ASSUME_TTL)
    assert _kinds(port_j) == _kinds(ref_j)
    assert {k for _, k in _kinds(port_j)} == {
        "node_add", "pod_add", "assume", "assume_bulk", "pod_move",
        "pod_update", "pod_del", "node_update", "node_del"}
    assert not port.is_assumed_pod(Pod.from_dict(placed[4]))
    assert port.is_assumed_pod(Pod.from_dict(placed[5]))

    ref_snap, port_snap = JaxSnapshot(), Snapshot()
    ref.update_snapshot(ref_snap)
    port.update_snapshot(port_snap)
    assert _node_state(port_snap) == _node_state(ref_snap)
    # the snapshot drops a node that left
    port.remove_node(Node.from_dict(nodes[5]))
    ref.remove_node(JaxNode.from_dict(nodes[5]))
    ref.update_snapshot(ref_snap)
    port.update_snapshot(port_snap)
    assert _node_state(port_snap) == _node_state(ref_snap)
    assert "node-5" not in [ni.node.name for ni in port_snap.list()]


def test_commit_target_flags_and_stale_verdicts():
    cache = SchedulerCache()
    tainted = node(2, taints=[{"key": "node.kubernetes.io/unreachable",
                               "effect": "NoExecute"}])
    for d in (node(0), node(1, unschedulable=True), tainted):
        cache.add_node(Node.from_dict(d))
    flags = cache.commit_target_flags(["node-0", "node-1", "node-2",
                                       "node-9"])
    assert set(flags) == {"node-1", "node-2", "node-9"}
    plain = Pod.from_dict(pod("p"))
    assert commit_target_stale(plain, flags["node-9"]) == "deleted"
    assert commit_target_stale(plain, flags["node-1"]) == "cordoned"
    assert commit_target_stale(plain, flags["node-2"]) == "unreachable"
    tolerant = Pod.from_dict(pod("t", tolerations=[
        {"key": "node.kubernetes.io/unreachable", "operator": "Exists"},
        {"key": "node.kubernetes.io/unschedulable", "operator": "Exists"}]))
    assert commit_target_stale(tolerant, flags["node-1"]) is None
    assert commit_target_stale(tolerant, flags["node-2"]) is None


def test_queue_update_delete_and_hint_match_reference():
    rng = np.random.default_rng(5)
    clock, ref, port = _queues()
    dicts = [pod(f"a{i}", priority=int(rng.choice([0, 10])))
             for i in range(12)]
    ref.add_many([JaxPod.from_dict(d) for d in dicts])
    port.add_many([Pod.from_dict(d) for d in dicts])
    assert port.pending_hint() == ref.pending_hint()
    assert port.num_active() == ref.num_active() == 12

    a, ca = ref.pop_batch(4, timeout=0)
    b, cb = port.pop_batch(4, timeout=0)
    for qa, qb, cycle in zip(a, b, range(ca, ca + 4)):
        ref.add_unschedulable_if_not_present(qa, cycle)
        port.add_unschedulable_if_not_present(qb, cycle)
    # a parked pod's label change may help it: back to an attempt
    old = next(d for d in dicts if d["metadata"]["name"] == a[0].pod.name)
    new = copy.deepcopy(old)
    new["metadata"]["labels"] = {"tier": "x"}
    ref.update(JaxPod.from_dict(old), JaxPod.from_dict(new))
    port.update(Pod.from_dict(old), Pod.from_dict(new))
    # a waiting pod's update keeps its place; a deleted one leaves
    waiting = next(d for d in dicts
                   if d["metadata"]["name"] not in {x.pod.name for x in a})
    ref.update(JaxPod.from_dict(waiting), JaxPod.from_dict(waiting))
    port.update(Pod.from_dict(waiting), Pod.from_dict(waiting))
    ref.delete(JaxPod.from_dict(dicts[-1]))
    port.delete(Pod.from_dict(dicts[-1]))
    # a pod no queue holds is added
    extra = pod("z", priority=100)
    ref.update(None, JaxPod.from_dict(extra))
    port.update(None, Pod.from_dict(extra))
    assert port.pending_hint() == ref.pending_hint() == (
        ref.num_active(), 100)
    ref.move_all_to_active_or_backoff_queue(q.NODE_ADD)
    port.move_all_to_active_or_backoff_queue(q.NODE_ADD)
    assert port.pods_moved == {q.NODE_ADD: 3}
    clock.t += 5.0
    ref.flush_backoff_completed()
    port.flush_backoff_completed()
    a, _ = ref.pop_batch(100, timeout=0)
    b, _ = port.pop_batch(100, timeout=0)
    assert [x.pod.name for x in b] == [x.pod.name for x in a]
    assert port.pending_hint() == ref.pending_hint() == (0, None)


def test_store_verbs_reach_cache_and_queue():
    store = ClusterStore()
    sched = Scheduler(store)
    sched.start()
    seen = []
    store.watch(lambda events: seen.append([(e.type, e.kind)
                                            for e in events]))
    for i in range(3):
        store.add_node(Node.from_dict(node(i, zone=False)))
    store.create_pods([Pod.from_dict(pod(f"p{i}")) for i in range(4)])
    assert store.get_pod("default", "p0").name == "p0"
    assert store.get_node("node-1").name == "node-1"
    store.bind("default", "p0", "", "node-0")
    store.bind("default", "p1", "", "node-1")
    seq = sched.cache.mutation_seq
    assert sched.queue.pending_active_count() == 2

    # a pending pod's update refreshes its queue entry; its delete drops it
    upd = Pod.from_dict(pod("p2", cpu="2"))
    store.update_pod(upd)
    assert sched.queue._active_q.get_by_key(upd.uid).pod is upd
    store.delete_pod("default", "p2")
    assert sched.queue.pending_active_count() == 1
    assert sched.cache.mutation_seq == seq

    # a pod no node fits parks; an assigned pod's deletion wakes it
    items, cycle = sched.queue.pop_batch(10, timeout=0)
    sched.queue.add_unschedulable_if_not_present(items[0], cycle)
    seen.clear()
    store.delete_pods([("default", "p0"), ("default", "p1"),
                       ("default", "missing")])
    assert seen == [[("DELETED", "Pod"), ("DELETED", "Pod")]]
    assert sched.cache.mutation_seq == seq + 2
    assert sched.queue.pods_moved == {q.ASSIGNED_POD_DELETE: 1}
    assert sched.queue.pending_active_count() == 1

    # an allocatable change is a mutation and a wakeup; the node's
    # removal leaves the node set
    bigger = Node.from_dict(node(2, cpu="32", zone=False))
    store.update_node(bigger)
    assert sched.cache.mutation_seq == seq + 3
    epoch = sched.cache.node_set_seq
    store.delete_node("node-2")
    assert store.get_node("node-2") is None
    assert sched.cache.node_set_seq == epoch + 1
    assert [ni.node.name for ni in sched.update_snapshot().list()] == [
        "node-0", "node-1"]
    sched.stop()
