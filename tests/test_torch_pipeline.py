"""The port's pipelined batch loop against its serialized arm and against
the JAX package's default loop, fed the same seeded event sequences:
contended waves (more pods than fit) and a node deleted between waves
must leave the same pods bound to the same nodes in every arm. Also: a
node deleted while a solved batch waits loses no pod and places none on
the dead node, the held batch chains onto the carried state without a
re-prepare, and the switches read their environment variables.

The helpers drive either package through the same calls (``port_arm``,
``jax_arm``, ``pump``); the mirror tests use them too."""

import contextlib
import copy
import os
import random
import time
from types import SimpleNamespace

import pytest

from kubernetes_tpu.api.resource import parse_quantity as jax_quantity
from kubernetes_tpu.api.types import Node as JaxNode, Pod as JaxPod
from kubernetes_tpu.apiserver.store import ClusterStore as JaxStore
from kubernetes_tpu.config.feature_gates import FeatureGates
from kubernetes_tpu.config.types import KubeSchedulerConfiguration
from kubernetes_tpu.ops.pallas_solver import XlaPlanesBackend
from kubernetes_tpu.scheduler.scheduler import Scheduler as JaxScheduler
from kubernetes_tpu.sidecar import attach_batch_scheduler
from kubernetes_tpu_torch.api.resource import parse_quantity
from kubernetes_tpu_torch.api.types import Node, Pod, shallow_copy
from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.ops import mirror as mirror_mod
from kubernetes_tpu_torch.scheduler.scheduler import Scheduler
from kubernetes_tpu_torch.sidecar import BatchScheduler, pipeline_enabled


def node_dict(i, cpu="8"):
    return {"metadata": {"name": f"n{i}"},
            "status": {"capacity": {"cpu": cpu, "memory": "16Gi",
                                    "pods": "110"}}}


def pod_dict(name, cpu):
    return {"metadata": {"name": name, "uid": f"u-{name}"},
            "spec": {"containers": [{"name": "c", "resources": {
                "requests": {"cpu": cpu}}}]}}


@contextlib.contextmanager
def _env(name, value):
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def _port_set_cpu(store, name, cpu):
    node = store.get_node(name)
    new = shallow_copy(node)
    new.metadata = shallow_copy(node.metadata)
    new.status = shallow_copy(node.status)
    new.status.allocatable = dict(node.status.allocatable,
                                  cpu=parse_quantity(cpu))
    store.update_node(new)


def _jax_set_cpu(store, name, cpu):
    node = copy.deepcopy(store.get_node(name))
    node.status.allocatable["cpu"] = jax_quantity(cpu)
    node.status.capacity["cpu"] = jax_quantity(cpu)
    store.update_node(node)


def port_arm(nodes, pipeline=True, mirror=True, max_batch=32, seed=None,
             validate=False):
    """The port's scheduler and batch loop on the CPU over ``nodes``;
    ``seed`` seeds its random draws."""
    store = ClusterStore()
    for d in nodes:
        store.add_node(Node.from_dict(d))
    sched = Scheduler(store, rng=random.Random(seed))
    bs = BatchScheduler(sched, max_batch=max_batch, device="cpu",
                        pipeline=pipeline, mirror=mirror, validate=validate)
    sched.start()
    return SimpleNamespace(store=store, sched=sched, bs=bs, pod=Pod.from_dict,
                           set_cpu=lambda n, c: _port_set_cpu(store, n, c))


def jax_arm(nodes, pipeline=True, mirror=True, max_batch=32, seed=None,
            validate=False):
    """The JAX package's scheduler and batch loop (planes scan, fixed
    batch size, filters in node order: ``parallelism=1``) over
    ``nodes``; ``mirror`` sets its KTPU_MIRROR, ``seed`` seeds the
    module-level ``random`` its serial path draws from."""
    store = JaxStore()
    for d in nodes:
        store.add_node(JaxNode.from_dict(d))
    sched = JaxScheduler.create(
        store, config=KubeSchedulerConfiguration(parallelism=1),
        feature_gates=FeatureGates({"TPUBatchScheduler": True}))
    with _env(mirror_mod.MIRROR_ENV, "on" if mirror else "off"):
        bs = attach_batch_scheduler(sched, max_batch=max_batch,
                                    backend=XlaPlanesBackend(),
                                    adaptive_chunk=False, pipeline=pipeline,
                                    validate=validate)
    if seed is not None:
        random.seed(seed)
    sched.start()
    return SimpleNamespace(store=store, sched=sched, bs=bs,
                           pod=JaxPod.from_dict,
                           set_cpu=lambda n, c: _jax_set_cpu(store, n, c))


def pump(arm, timeout=30.0):
    """Run batches until nothing is due an attempt, then commit what is
    held."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        arm.sched.queue.flush_backoff_completed()
        if arm.bs.run_batch(pop_timeout=0.0):
            continue
        if arm.sched.queue.pending_active_count() == 0 \
                and arm.bs._pending is None:
            break
        time.sleep(0.01)
    arm.bs.flush()
    wait = getattr(arm.sched, "wait_for_inflight_bindings", None)
    if wait is not None:
        assert wait()


def bound_set(arm):
    return sorted((p.metadata.name, p.spec.node_name)
                  for p in arm.store.list_pods())


def stop(arm):
    arm.sched.stop()


def _waves(n_waves, per_wave, cpu="1"):
    return [[pod_dict(f"w{w}-p{i}", cpu) for i in range(per_wave)]
            for w in range(n_waves)]


def run_waves(make_arm, waves, nodes=12, kill_after=None, **kw):
    """Create each wave and pump it to quiescence; ``kill_after`` =
    (wave index, node name) deletes that node after that wave."""
    arm = make_arm([node_dict(i) for i in range(nodes)], **kw)
    try:
        for wi, wave in enumerate(waves):
            arm.store.create_pods([arm.pod(d) for d in wave])
            pump(arm)
            if kill_after is not None and wi == kill_after[0]:
                arm.store.delete_node(kill_after[1])
        return bound_set(arm)
    finally:
        stop(arm)


SEQUENCES = {
    # 120 pods of 1 cpu on 96 cores
    "contended": dict(waves=_waves(3, 40)),
    "node-death": dict(waves=_waves(3, 30), kill_after=(0, "n3")),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_pipelined_equals_serialized_and_reference(name):
    seq = SEQUENCES[name]
    piped = run_waves(port_arm, pipeline=True, **seq)
    serial = run_waves(port_arm, pipeline=False, **seq)
    ref = run_waves(jax_arm, pipeline=True, **seq)
    assert piped == serial == ref
    if name == "contended":
        assert sum(1 for _, n in piped if n) == 96
    else:
        assert all(node != "n3" for pod, node in piped
                   if not pod.startswith("w0-"))


def test_node_death_while_a_batch_is_held_loses_nothing():
    arm = port_arm([node_dict(i) for i in range(8)], max_batch=16)
    try:
        arm.store.create_pods([arm.pod(pod_dict(f"p{i}", "1"))
                               for i in range(48)])
        arm.bs.run_batch(pop_timeout=0.1)
        assert arm.bs.holding
        arm.store.delete_node("n2")
        pump(arm)
        pods = arm.store.list_pods()
        assert len(pods) == 48 and all(p.spec.node_name for p in pods)
        assert not any(p.spec.node_name == "n2" for p in pods)
        assert arm.bs.discards == 1
    finally:
        stop(arm)


def test_held_batches_chain_on_the_carried_state():
    """Past the first rebuild, back-to-back pipelined solves run on the
    carried state: no prepare, incremental hits, chained dispatches, two
    batches in flight."""
    arm = port_arm([node_dict(i, cpu="16") for i in range(8)], max_batch=16)
    try:
        arm.store.create_pods([arm.pod(pod_dict("seed", "100m"))])
        pump(arm)
        calls = []
        backend = arm.bs.session.backend
        real = backend.prepare
        backend.prepare = lambda *a: calls.append(1) or real(*a)
        hits = arm.bs.session.incremental_hits
        arm.store.create_pods([arm.pod(pod_dict(f"p{i}", "200m"))
                               for i in range(64)])
        pump(arm)
        assert calls == []
        assert arm.bs.session.incremental_hits >= hits + 4
        assert arm.bs.session.carry_chained >= 3
        assert arm.bs.pipeline_depth_max == 2
        assert arm.bs.pipeline_info() == {"depth": 2, "discards": 0}
        assert len(arm.bs.session.handoffs) >= 4
        assert all(p.spec.node_name for p in arm.store.list_pods())
    finally:
        stop(arm)


def test_serialized_arm_never_holds_a_batch():
    arm = port_arm([node_dict(i) for i in range(4)], pipeline=False,
                   max_batch=8)
    try:
        arm.store.create_pods([arm.pod(pod_dict(f"p{i}", "500m"))
                               for i in range(30)])
        while arm.bs.run_batch(pop_timeout=0.0):
            assert not arm.bs.holding
        assert arm.bs.flush() == 0
        assert arm.bs.pipeline_info() is None
        assert all(p.spec.node_name for p in arm.store.list_pods())
    finally:
        stop(arm)


def test_switches_read_the_environment(monkeypatch):
    for off in ("off", "0", "false", " OFF "):
        monkeypatch.setenv("KTPU_PIPELINE", off)
        monkeypatch.setenv("KTPU_MIRROR", off)
        assert not pipeline_enabled() and not mirror_mod.mirror_enabled()
        bs = BatchScheduler(Scheduler(ClusterStore()), device="cpu")
        assert not bs.pipeline_enabled and bs.mirror_info() is None
    monkeypatch.delenv("KTPU_PIPELINE")
    monkeypatch.delenv("KTPU_MIRROR")
    assert pipeline_enabled() and mirror_mod.mirror_enabled()
    bs = BatchScheduler(Scheduler(ClusterStore()), device="cpu")
    assert bs.pipeline_enabled and bs.mirror_info() == {
        "events": 0, "catch_ups": 0, "scatter_bytes": 0, "reseeds": 0}
    # the arguments override the environment
    bs = BatchScheduler(Scheduler(ClusterStore()), device="cpu",
                        pipeline=False, mirror=False)
    assert not bs.pipeline_enabled and bs.session.mirror is None


def test_commit_refuses_placements_on_a_node_gone_since_the_solve(
        monkeypatch):
    """The stale-node guard: a held batch committed after its node died
    (the discard check blinded here) binds nothing there, sends those
    pods to the serial path (which binds them elsewhere) and drops the
    carried state."""
    arm = port_arm([node_dict(i) for i in range(4)], max_batch=8)
    try:
        arm.store.create_pods([arm.pod(pod_dict(f"p{i}", "1"))
                               for i in range(16)])
        arm.bs.run_batch(pop_timeout=0.1)
        held = arm.bs._pending
        on_n0 = {q.pod.name for (q, _), a in zip(held["batch"],
                                                 held["handle"])
                 if held["cluster"].node_names[a] == "n0"}
        assert on_n0
        monkeypatch.setattr(arm.bs.session, "mirror_current", lambda: True)
        arm.store.delete_node("n0")
        arm.bs.run_batch(pop_timeout=0.0)
        # the drift dropped the state: the new batch was solved on a
        # rebuild
        assert arm.bs.session.rebuilds == 2
        assert not any(p.spec.node_name == "n0"
                       for p in arm.store.list_pods())
        rerouted = {p.name: p.spec.node_name for p in arm.store.list_pods()
                    if p.name in on_n0}
        assert all(rerouted.values()), rerouted
    finally:
        stop(arm)
