"""The port's rolling-upgrade harness (``harness/upgrade.py``) against the
JAX package's (the JAX ``tests/test_upgrade.py``):

- ``run_upgrade_mini_cell(nodes=200, pods=160, partitions=2)``: two
  in-process partition apiservers and a scheduler replica rolled one at
  a time under a writer, one client pinned to codec v1, the replica's
  batch path on the CPU. It holds every invariant the JAX test
  (``tests/test_upgrade.py::TestRollingMiniCell``) asserts of the JAX
  cell: informer equal to server truth, zero lost or duplicated events,
  no relist of an unmoved slice, no resourceVersion regression, one
  epoch, each process rolled once, the v1 pin re-negotiated across each
  seam (the JAX cell itself runs in that test);
- the verdict contract (``_upgrade_ok``) gives the JAX verdicts on the
  green result and on each flipped invariant; the scenario names and
  the open-loop trace are the JAX package's;
- one spawned roll, the chaos cell's (two WAL-backed partition
  processes with prespawned standbys, one replica on the CPU), restarts
  every process once and binds every pod, with no torch in a child;
- the replay engine over a REST client, its stream starting late, sees
  every bind, and a rolled-out replica's late binds still count;
- a slow watcher is dropped once and counted (``watch_drops``, which the
  roll reports);
- the entry points that reach the card default to it and raise without
  one.

Tolerance: exact equality of verdicts, traces and invariants; the roll
races a writer, so no placement is compared."""

import dataclasses

import pytest
import torch

from kubernetes_tpu.harness import upgrade as jax_upgrade
from kubernetes_tpu_torch.harness import upgrade


def test_mini_cell_holds_every_invariant_of_the_reference_test():
    port = upgrade.run_upgrade_mini_cell(nodes=200, pods=160, partitions=2,
                                         device="cpu")
    assert port["errors"] == []
    assert port["confirmed"] == port["server_pods"] == 160
    assert port["server_bound"] == port["server_pods"]
    assert port["scheduled"] >= port["confirmed"]
    assert port["duplicates"] == 0
    assert port["rolled_partitions"] == 2 and port["rolled_replicas"] == 1
    assert all(r["rolled"] for r in port["partition_records"])
    assert port["lost_watches"] == 0
    assert port["missing"] == port["extra"] == port["stale"] == []
    assert port["informer_pods"] == port["server_pods"]
    assert port["informer_nodes"] == 200
    assert port["unmoved_relists"] == 0
    assert port["rv_regressions"] == []
    assert port["epoch"] == 3
    assert port["v1_pin_ok"]
    assert all(v == 1 for v in port["v1_negotiated"].values())
    assert port["v1_renegotiations"] >= 2
    assert port["codec_failures"] == 0
    assert 0.0 < port["frozen_ms_max"] < 2000.0


def _green_result() -> dict:
    return {
        "lost_pods": 0, "injected": 200, "ever_bound": 200,
        "send_errors": [], "duplicates": 0, "doubles": 0,
        "lost_watches": 0, "unmoved_relists": 0, "rv_regressions": 0,
        "rolled_exactly_once": True, "epochs": [3],
        "frozen_ms_max": 326.7, "freeze_budget_ms": 2000.0,
        "codec_failures": 0, "v1_pin_ok": True,
        "slo_verdicts_ok": True,
    }


@pytest.mark.parametrize("mutation", [
    {}, {"lost_pods": 1}, {"ever_bound": 150}, {"send_errors": ["boom"]},
    {"duplicates": 2}, {"doubles": 1}, {"lost_watches": 1},
    {"unmoved_relists": 1}, {"rv_regressions": 1},
    {"rolled_exactly_once": False}, {"epochs": [2, 3]},
    {"frozen_ms_max": 2500.0}, {"codec_failures": 1},
    {"v1_pin_ok": False}, {"slo_verdicts_ok": False},
    {"slo_verdicts_ok": None}, {"injected": 0, "ever_bound": 0},
])
def test_the_verdict_equals_the_reference(mutation):
    res = _green_result()
    res.update(mutation)
    assert upgrade._upgrade_ok(res) == jax_upgrade._upgrade_ok(res)


def test_scenarios_and_the_trace_equal_the_reference():
    assert upgrade.UPGRADE_SCENARIOS == jax_upgrade.UPGRADE_SCENARIOS
    assert (upgrade.UPGRADE_QPS, upgrade.FREEZE_BUDGET_S,
            upgrade.P99_ARRIVAL_TO_BIND_BUDGET_MS) == (
        jax_upgrade.UPGRADE_QPS, jax_upgrade.FREEZE_BUDGET_S,
        jax_upgrade.P99_ARRIVAL_TO_BIND_BUDGET_MS)
    ours = upgrade.build_upgrade_trace(16, 400, qps=100.0)
    ref = jax_upgrade.build_upgrade_trace(16, 400, qps=100.0)
    assert [dataclasses.asdict(e) for e in ours.events] == \
        [dataclasses.asdict(e) for e in ref.events]
    assert len({e.namespace for e in ours.events}) == 16
    with pytest.raises(ValueError, match="scenario"):
        upgrade.run_chaos_upgrade(1, scenario="upside-down")


def test_a_spawned_roll_restarts_every_process_once():
    """The chaos cell's roll (2 spawned partitions, 1 replica); the
    verdict's timing checks (the SLO, the freeze budget) depend on this
    host's load and are left out."""
    res = upgrade.run_upgrade_roll(partitions=2, replicas=1, pods=200,
                                   qps=100.0, seed=11, node_cpu=16,
                                   max_batch=256, device="cpu")
    _, why = upgrade._upgrade_ok(res)
    assert set(why.split()) <= {"slo", "freeze_budget"}, why
    assert res["injected"] == res["ever_bound"] == res["server_bound"] \
        == res["server_pods"] == 200
    assert res["partition_restarts"] == [1, 1]
    assert res["replica_restarts"] == [1]
    assert res["epochs"] == [3] and res["codec_renegotiations"] >= 2
    assert not res["children_import_torch"]
    assert res["device"] == "cpu"


def test_the_replay_engine_over_rest_sees_binds_before_its_stream_lists(
        monkeypatch):
    """The roll's engine counts each arrival's bind from its watch: with
    the stream's thread starting late (a loaded host), binds made before
    its first list must still arrive, so the engine lists first and the
    stream resumes from that list's version."""
    import threading
    import time

    from kubernetes_tpu_torch.apiserver.rest import APIServer
    from kubernetes_tpu_torch.apiserver.store import ClusterStore
    from kubernetes_tpu_torch.client.restcluster import RestClusterClient
    from kubernetes_tpu_torch.workloads.replay import ReplayEngine

    real = RestClusterClient._watch_loop

    def late(self, *args, **kwargs):
        time.sleep(1.5)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(RestClusterClient, "_watch_loop", late)
    store = ClusterStore()
    server = APIServer(store=store).start()
    client = RestClusterClient(server.url, watch_kinds=("Pod",))
    stop = threading.Event()

    def binder():   # binds every pod as it arrives
        while not stop.is_set():
            for p in store.list_pods():
                if not p.spec.node_name:
                    store.bind(p.namespace, p.metadata.name, p.uid, "n0")
            time.sleep(0.01)

    t = threading.Thread(target=binder, daemon=True)
    t.start()
    trace = upgrade.build_upgrade_trace(16, 20, qps=200.0)
    engine = ReplayEngine(client, trace, expire=False)
    try:
        engine.start()
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and len(engine._bind) < 20:
            time.sleep(0.05)
        assert engine.finish().ever_bound == 20
    finally:
        stop.set()
        t.join(timeout=5.0)
        client.close()
        server.shutdown_server()


def test_a_rolled_out_replicas_late_binds_still_count():
    """A bind a replica started before its cut can land after it: the
    fleet reads a rolled-out replica's count when asked, not at the
    cut."""
    from kubernetes_tpu_torch.metrics.scheduler_metrics import (
        SchedulerMetrics,
    )

    class Replica:
        def __init__(self):
            self.metrics = SchedulerMetrics()

    old, new = Replica(), Replica()
    fleet = upgrade._ReplicaFleet.__new__(upgrade._ReplicaFleet)
    fleet.replicas, fleet.retired = [new], [old]
    old.metrics.e2e_scheduling_duration.observe_many([0.1] * 3,
                                                     "scheduled")
    new.metrics.e2e_scheduling_duration.observe_many([0.1] * 2,
                                                     "scheduled")
    assert fleet.bound_count() == 5
    old.metrics.e2e_scheduling_duration.observe(0.1, "scheduled")
    assert fleet.bound_count() == 6


def test_a_slow_watcher_is_dropped_once_and_counted():
    """The counter the roll reports (``watch_drops``): a watcher that
    reads nothing is dropped once its frame queue fills, and counted
    once."""
    import http.client

    from kubernetes_tpu_torch.apiserver import codec
    from kubernetes_tpu_torch.apiserver.rest import APIServer
    from kubernetes_tpu_torch.apiserver.store import ClusterStore
    from kubernetes_tpu_torch.testing import MakePod

    store = ClusterStore()
    server = APIServer(store=store).start()
    host, port = server.url.split("://")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request("GET", "/api/v1/pods?watch=1&resourceVersion=0",
                     headers={"Accept": codec.BINARY_CONTENT_TYPE})
        assert conn.getresponse().status == 200
        assert server.watch_drops == 0
        for lo in range(0, 40_000, 2_000):
            store.create_pods([MakePod().name(f"p{i}").uid(f"u{i}").obj()
                               for i in range(lo, lo + 2_000)])
            if server.watch_drops:
                break
        store.create_pods([MakePod().name("last").uid("ul").obj()])
        assert server.watch_drops == 1
    finally:
        conn.close()
        server.shutdown_server()


def test_the_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        upgrade.run_upgrade_roll(pods=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        upgrade.run_upgrade_row(pods=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        upgrade.run_upgrade_mini_cell()
