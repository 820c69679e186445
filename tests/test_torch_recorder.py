"""The port's EventRecorder and Event objects against the JAX package's:
after SchedulingBasic, Unschedulable and a small Preemption row through
both harnesses, the aggregated (object, type, reason, message, count)
set of the stored Events is equal; the recorder aggregates correlated
occurrences, drops past its queue's bound, and its writes never reach
the scheduler's cache: the session's rebuild count and the cache's
mutation sequence do not move."""

import pytest

from kubernetes_tpu_torch.api.types import Event, Node, Pod, object_reference
from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.client.events import EventRecorder
from kubernetes_tpu_torch.harness import workloads
from kubernetes_tpu_torch.scheduler.scheduler import Scheduler
from kubernetes_tpu_torch.sidecar import BatchScheduler
from test_torch_metrics import run_both


@pytest.mark.parametrize("name,reasons", [
    ("SchedulingBasic", {"Scheduled"}),
    ("Unschedulable", {"Scheduled", "FailedScheduling"}),
    ("Preemption", {"Scheduled", "Preempted"}),
])
def test_aggregated_events_equal_the_reference(name, reasons):
    rows = run_both(name)
    got = rows["port"]["events"]
    assert got == rows["jax"]["events"]
    assert {reason for _, _, reason, _, _ in got} == reasons


def _pod(i):
    return Pod.from_dict(workloads.basic_pod(i))


def test_correlated_occurrences_aggregate_and_the_queue_bounds():
    store = ClusterStore()
    rec = EventRecorder(store, "default-scheduler", queue_cap=5)
    a, b = _pod(0), _pod(1)
    for _ in range(3):
        rec.event(a, "Warning", "FailedScheduling", "0/3 nodes")
    rec.eventf(b, "Normal", "Scheduled", "assigned %s to %s", "p1", "n1")
    rec.event(b, "Normal", "Scheduled", "assigned p1 to n1")
    rec.event(b, "Normal", "Scheduled", "dropped: the queue is full")
    assert rec.dropped == 1
    assert rec.flush_now() == 5
    got = sorted((e.involved_object.name, e.reason, e.message, e.count)
                 for e in store.list_events())
    assert got == [(a.name, "FailedScheduling", "0/3 nodes", 3),
                   (b.name, "Scheduled", "assigned p1 to n1", 2)]
    # a later occurrence bumps the stored Event
    rec.event(a, "Warning", "FailedScheduling", "0/3 nodes")
    rec.flush_now()
    (ev,) = store.list_events(involved_name=a.name)
    assert ev.count == 4 and ev.source_component == "default-scheduler"
    assert store.prune_expired_events(now=ev.last_timestamp + 7200) == 2
    assert store.list_events() == []


def test_event_objects_and_store_verbs():
    store = ClusterStore()
    pod = _pod(3)
    ref = object_reference(pod)
    assert (ref.kind, ref.namespace, ref.name, ref.uid) == (
        "Pod", "default", pod.name, pod.uid)
    ev = Event(involved_object=ref, reason="Scheduled")
    ev.metadata.name = "e1"
    assert store.create_events([ev]) == 1
    assert store.create_events([ev]) == 0
    assert store.get_event("default", "e1") is ev
    ev.count = 2
    assert store.update_event(ev).count == 2
    missing = Event(involved_object=ref, reason="Scheduled")
    missing.metadata.name = "e2"
    with pytest.raises(KeyError):
        store.update_event(missing)


def test_event_writes_leave_the_session_alone():
    store = ClusterStore()
    sched = Scheduler(store)
    bs = BatchScheduler(sched, max_batch=16, device="cpu")
    sched.start()
    for i in range(4):
        store.add_node(Node.from_dict(workloads.node_template(i)))
    store.create_pods([_pod(i) for i in range(16)])
    bs.run_batch(pop_timeout=0.0)
    session = bs.session
    assert session.mirror_current()
    seq, rebuilds = sched.cache.mutation_seq, session.rebuilds
    for i in range(200):
        sched.recorder.event(_pod(i), "Warning", "FailedScheduling", f"m{i}")
    sched.recorder.flush_now()
    assert len(store.list_events()) >= 200
    assert sched.cache.mutation_seq == seq and session.mirror_current()
    store.create_pods([_pod(i) for i in range(16, 32)])
    while bs.run_batch(pop_timeout=0.0):
        pass
    assert session.rebuilds == rebuilds
    assert all(p.spec.node_name for p in store.list_pods())
    sched.stop()
