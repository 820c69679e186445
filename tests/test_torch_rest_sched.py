"""The port's scheduler over the REST fabric, on the CPU.

- Nodes and pods in the store before ``start()``, one drain taking them
  all: the port's ``Scheduler`` and batch loop over ``RestClusterClient``
  bind the same pods to the same nodes as the JAX scheduler over the JAX
  fabric and as the port's store-direct run (the bind on the binding
  pool, the watch's bind events confirming the assumes).
- A bulk bind that fails on the pool forgets its pods later: they go
  back to the queue and the cache's mutation count moves (the device
  mirror's invalidation), and ``stop()`` waits for binds already on the
  pool.
- ``run_workload_rest`` at a small size on the CPU: the apiserver's own
  bound count equals the scheduler's, the WAL holds every write, the
  metrics federation has both instances, watch delivery is observed,
  ``rest_availability`` has a verdict, and neither spawned child imported
  torch.
"""

import random
import threading
import time

from kubernetes_tpu.apiserver.rest import APIServer as JaxAPIServer
from kubernetes_tpu.apiserver.store import ClusterStore as JaxStore
from kubernetes_tpu.api.types import Node as JaxNode, Pod as JaxPod
from kubernetes_tpu.client.restcluster import (
    RestClusterClient as JaxRestClient,
)
from kubernetes_tpu.config.feature_gates import FeatureGates as JaxGates
from kubernetes_tpu.config.types import KubeSchedulerConfiguration
from kubernetes_tpu.ops.pallas_solver import XlaPlanesBackend
from kubernetes_tpu.scheduler.scheduler import Scheduler as JaxScheduler
from kubernetes_tpu.sidecar import attach_batch_scheduler as jax_attach
from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.apiserver.rest import APIServer
from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.client.restcluster import RestClusterClient
from kubernetes_tpu_torch.harness.rest_perf import run_workload_rest
from kubernetes_tpu_torch.scheduler.scheduler import Scheduler
from kubernetes_tpu_torch.sidecar import BatchScheduler

NODES, PODS, MAX_BATCH = 24, 110, 128


def _node(i):
    return {"metadata": {"name": f"n{i}", "labels": {"zone": f"z{i % 3}"}},
            "status": {"capacity": {"cpu": str(4 + i % 5), "memory": "16Gi",
                                    "pods": "110"}}}


def _pod(i):
    cpu = ("250m", "500m", "1", "1500m")[i % 4]
    return {"metadata": {"name": f"p{i}", "uid": f"u-{i}",
                         "labels": {"app": f"a{i % 5}"}},
            "spec": {"containers": [{"name": "c", "resources": {
                "requests": {"cpu": cpu, "memory": "128Mi"}}}]}}


def _fill(store, node_cls, pod_cls):
    for i in range(NODES):
        store.add_node(node_cls.from_dict(_node(i)))
    store.create_pods([pod_cls.from_dict(_pod(i)) for i in range(PODS)])


def _drain(sched, bs, store, timeout=60.0):
    """One drain takes every pod; then wait for the binds to land."""
    assert bs.run_batch(pop_timeout=5.0) == PODS
    bs.flush()
    assert sched.wait_for_inflight_bindings(timeout=timeout)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        placed = {p.metadata.name: p.spec.node_name
                  for p in store.list_pods()}
        if all(placed.values()):
            return placed
        time.sleep(0.02)
    raise AssertionError("pods left unbound")


def _jax_rest():
    store = JaxStore()
    _fill(store, JaxNode, JaxPod)
    server = JaxAPIServer(store=store).start()
    client = JaxRestClient(server.url)
    sched = JaxScheduler.create(
        client, config=KubeSchedulerConfiguration(parallelism=1),
        feature_gates=JaxGates({"TPUBatchScheduler": True}))
    bs = jax_attach(sched, max_batch=MAX_BATCH, backend=XlaPlanesBackend(),
                    adaptive_chunk=False)
    sched.start()
    try:
        return _drain(sched, bs, store)
    finally:
        sched.stop()
        client._stop_watches()
        server.shutdown_server()


def _port(remote):
    store = ClusterStore()
    _fill(store, Node, Pod)
    server = client = None
    if remote:
        server = APIServer(store=store).start()
        client = RestClusterClient(server.url)
    sched = Scheduler(client or store, rng=random.Random(0))
    bs = BatchScheduler(sched, max_batch=MAX_BATCH, device="cpu",
                        adaptive_chunk=False)
    sched.start()
    try:
        placed = _drain(sched, bs, store)
        return placed, sched
    finally:
        sched.stop()
        if client is not None:
            client.close()
            server.shutdown_server()


def test_rest_placements_equal_reference_and_store_direct():
    want = _jax_rest()
    got, sched = _port(remote=True)
    direct, _ = _port(remote=False)
    assert len(want) == PODS
    assert got == want == direct
    assert sched.async_bulk_bind
    assert sched.metrics.e2e_scheduling_duration.count("scheduled") == PODS


# pods that arrive in waves while the loop pumps, in batches far smaller
# than the stream, on nodes they fill to about four fifths of their cpu
WAVE_PODS, WAVE, SMALL_BATCH = 144, 16, 12


def _waves(remote):
    """Pods created in waves by another thread while the batch loop
    pumps: over REST, later solves run while earlier batches' binds come
    back over the watch and confirm their assumes."""
    store = ClusterStore()
    for i in range(NODES):
        store.add_node(Node.from_dict(_node(i)))
    server = client = None
    if remote:
        server = APIServer(store=store).start()
        client = RestClusterClient(server.url)
    sched = Scheduler(client or store, rng=random.Random(0))
    bs = BatchScheduler(sched, max_batch=SMALL_BATCH, device="cpu",
                        adaptive_chunk=False)

    def create():
        for w in range(0, WAVE_PODS, WAVE):
            store.create_pods([Pod.from_dict(_pod(i))
                               for i in range(w, w + WAVE)])
            time.sleep(0.03)

    creator = threading.Thread(target=create)
    sched.start()
    try:
        creator.start()
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            bs.run_batch(pop_timeout=0.01)
            if not creator.is_alive() and \
                    store.count_bound() == WAVE_PODS:
                break
        bs.flush()
        assert sched.wait_for_inflight_bindings(timeout=30.0)
        return {p.metadata.name: p.spec.node_name
                for p in store.list_pods()}, sched, bs
    finally:
        creator.join()
        sched.stop()
        if client is not None:
            client.close()
            server.shutdown_server()


def test_rest_waves_equal_store_direct():
    """Many small solves over a stream of arriving pods: the REST run's
    placements equal the store-direct run's, pod for pod, so no bind
    confirmation that reached the cache during a later solve was
    counted twice or lost."""
    direct, _, _ = _waves(remote=False)
    got, sched, bs = _waves(remote=True)
    assert len(direct) == WAVE_PODS and all(direct.values())
    assert got == direct
    assert sched.async_bulk_bind
    assert bs.session.backend.solves >= WAVE_PODS // SMALL_BATCH


class _FailingBinds(RestClusterClient):
    """A remote client whose bulk binds fail once the flag is set."""

    fail = False
    started = None

    def bind_many(self, bindings):
        if self.started is not None:
            self.started.set()
            time.sleep(0.3)
        if self.fail:
            raise ConnectionError("apiserver gone")
        return super().bind_many(bindings)


def test_failed_async_bind_forgets_later_and_stop_waits():
    store = ClusterStore()
    _fill(store, Node, Pod)
    server = APIServer(store=store).start()
    client = _FailingBinds(server.url, max_retries=0)
    client.fail = True
    try:
        sched = Scheduler(client, rng=random.Random(0))
        bs = BatchScheduler(sched, max_batch=MAX_BATCH, device="cpu",
                            adaptive_chunk=False, pipeline=False)
        sched.start()
        seq0 = sched.cache.mutation_seq
        assert bs.run_batch(pop_timeout=5.0) == PODS
        assert sched.wait_for_inflight_bindings(timeout=30.0)
        # every assume forgotten on the pool: assumes and forgets both
        # moved the sequence, and nothing stays assumed
        assert sched.cache.mutation_seq >= seq0 + 2 * PODS
        assert not any(sched.cache.is_assumed_pod(p)
                       for p in store.list_pods())
        assert not any(p.spec.node_name for p in store.list_pods())
        # requeued to backoff, as a refused bind is
        assert sched.queue.pending_active_count() == PODS
        # binds already on the pool finish before stop() returns
        client.fail = False
        client.started = threading.Event()
        sched.queue.flush_backoff_completed()
        time.sleep(1.1)
        sched.queue.flush_backoff_completed()
        assert bs.run_batch(pop_timeout=5.0) == PODS
        assert client.started.wait(5.0)
        sched.stop()
        assert sched._inflight_bindings == 0
        assert sum(1 for p in store.list_pods() if p.spec.node_name) == PODS
    finally:
        client.close()
        server.shutdown_server()


def test_run_workload_rest_on_cpu_agrees_with_store_truth():
    res = run_workload_rest("SchedulingBasic", nodes=20, measure_pods=150,
                            max_batch=64, device="cpu")
    m = res.metrics
    assert res.device == "cpu"
    assert m["server_pods_bound"] == m["scheduler_bound"] == 150
    assert m["server_pods_total"] == 150
    assert m["wal_entries"] >= 20 + 2 * 150
    assert m["federation_instances"] == ["apiserver", "scheduler"]
    assert m["watch_delivery_p99_ms"] > 0
    assert m["children_import_torch"] is False
    assert m["rv_regressions"] == 0
    assert m["overcommitted_nodes"] == []
    # create to bind, on the apiserver's clock, over every measured pod
    c2b = m["create_to_bind"]
    assert c2b["n"] == 150 and 0 < c2b["Perc50"] <= c2b["Perc99"]
    assert "rest_availability" in res.freshness["slo"]
    assert res.solves >= 1 and res.pods_per_second > 0
