"""Chaos over REST (``harness/chaos_rest.py``) and the small parts it
needs, against the JAX package: the fault profiles' specs; the WAL's
``fsync``, once per inline append; ``APIServer(fault_gate=)`` serving
through the gate it is given, as the JAX server does; a failed status
write that still requeues the pod, as the JAX scheduler's does; and one
small seeded cell with a SIGKILL and a restore from the WAL, whose
apiserver child imports no torch."""

import http.client
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from kubernetes_tpu.apiserver.faults import (
    FaultGate as JaxFaultGate,
    FaultRule as JaxFaultRule,
)
from kubernetes_tpu.apiserver.rest import APIServer as JaxAPIServer
from kubernetes_tpu.harness import chaos_rest as jax_rest
from kubernetes_tpu_torch.apiserver import wal as wal_mod
from kubernetes_tpu_torch.apiserver.faults import FaultGate, FaultRule
from kubernetes_tpu_torch.apiserver.rest import APIServer
from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.harness import chaos_rest
from kubernetes_tpu_torch.testing import MakeNode, MakePod

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("seed", [11, 23, 37, 41, 53])
def test_fault_profiles_match_the_reference(seed):
    assert list(chaos_rest.FAULT_PROFILES) == list(jax_rest.FAULT_PROFILES)
    for name, spec in chaos_rest.FAULT_PROFILES.items():
        assert spec(seed) == jax_rest.FAULT_PROFILES[name](seed), name
    assert chaos_rest.default_fault_spec(seed) == \
        jax_rest.default_fault_spec(seed)


@pytest.mark.parametrize("resp", [
    {"failures": []}, {"failures": [{"code": 409}, {"code": 409}]},
    {"failures": [{"code": 409}, {"code": 500}]}, {}, None, "text"])
def test_tolerable_bulk_answers_match_the_reference(resp):
    assert chaos_rest._tolerable(resp) == jax_rest._tolerable(resp)


def _pods(names):
    return [MakePod().name(n).uid(f"u-{n}").req({"cpu": "100m"}).obj()
            for n in names]


@pytest.mark.parametrize("fsync,async_serialize",
                         [(True, False), (False, False), (True, True)])
def test_wal_fsyncs_each_append(tmp_path, monkeypatch, fsync,
                                async_serialize):
    store = ClusterStore()
    store.add_node(MakeNode().name("n1").obj())
    calls = []
    real = os.fsync
    handle = wal_mod.attach_wal(store, str(tmp_path), fsync=fsync,
                                async_serialize=async_serialize)
    # after the attach's snapshot (fsynced on its own file)
    monkeypatch.setattr(wal_mod.os, "fsync",
                        lambda fd: (calls.append(fd), real(fd)))
    try:
        for pod in _pods(["a", "b", "c"]):
            store.create_pod(pod)
        store.create_pods(_pods(["d", "e", "f", "g"]))
        assert handle.drain()
        appends = 7
        assert len(calls) == (appends if fsync else 0)
        assert handle.fsync is fsync
    finally:
        handle.close()
    restored = wal_mod.restore_store(str(tmp_path))
    assert sorted(p.name for p in restored.list_pods()) == list("abcdefg")


def _get(url, path):
    host, port = url.split("://", 1)[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=10)
    try:
        conn.request("GET", path, headers={"Accept": "application/json"})
        resp = conn.getresponse()
        body = resp.read()
        return resp.status, json.loads(body) if body else {}
    finally:
        conn.close()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_api_server_serves_through_the_given_gate(pkg):
    """As ``tests/test_slo.py`` does for the JAX server: a gate armed
    before the server starts answers through it."""
    gate_t, rule_t, server_t = ((JaxFaultGate, JaxFaultRule, JaxAPIServer)
                                if pkg == "jax"
                                else (FaultGate, FaultRule, APIServer))
    gate = gate_t()
    gate.add_rule(rule_t("error", verb="GET", resource="pods", code=503,
                         retry_after=0.1))
    server = server_t(fault_gate=gate).start()
    try:
        assert server.fault_gate is gate
        pods_code, pods_body = _get(server.url, "/api/v1/pods")
        nodes_code, _ = _get(server.url, "/api/v1/nodes")
    finally:
        server.shutdown_server()
    assert (pods_code, nodes_code) == (503, 200)
    assert "injected" in json.dumps(pods_body)
    assert sum(gate.snapshot()["injected"].values()) == 1


def test_default_api_server_builds_its_own_gate():
    server = APIServer()
    try:
        assert isinstance(server.fault_gate, FaultGate)
    finally:
        server.server_close()


def test_racing_list_cache_misses_keep_the_newer_list():
    """Two misses of the list cache racing: the one that listed earlier
    stores last. The entry keeps the newer list, so a later hit never
    serves a version older than one already sent (a client's list
    watchdog saw Service lists go back from 150 to 148 under chaos)."""
    from kubernetes_tpu_torch.apiserver import codec

    store = ClusterStore()
    store.add_node(MakeNode().name("n1").obj())
    server = APIServer(store=store)
    real = store.list_objects_with_rv
    sent = []

    def racing(kind, namespace=None):
        objs, rv = real(kind, namespace)
        if not sent:
            # while this list is on its way, a write of another kind
            # lands and a second request lists and caches the newer one
            sent.append(None)
            store.create_pod(_pods(["p"])[0])
            sent[0] = codec.decode(server.cached_list_binary(
                "Node", None))["resourceVersion"]
        return objs, rv

    store.list_objects_with_rv = racing
    try:
        first = codec.decode(server.cached_list_binary("Node", None))
        store.list_objects_with_rv = real
        later = codec.decode(server.cached_list_binary("Node", None))
    finally:
        server.server_close()
    assert first["resourceVersion"] < sent[0]
    assert later["resourceVersion"] == sent[0]


def test_a_namespace_list_never_goes_back_behind_another_scope():
    """A cached list of one namespace is older than a list of the same
    kind over all namespaces taken since: it is listed again, so a
    client that lists both never sees the kind's version go back (the
    scheduler's Service informer and its spreading plugin's namespace
    lists did, under chaos on the card: Service 152 -> 108)."""
    from kubernetes_tpu_torch.apiserver import codec

    store = ClusterStore()
    store.add_node(MakeNode().name("n1").obj())
    server = APIServer(store=store)

    def rv(namespace):
        return codec.decode(server.cached_list_binary(
            "Service", namespace))["resourceVersion"]

    try:
        first = rv("default")
        store.create_pod(_pods(["p"])[0])
        every = rv(None)
        again = rv("default")
        store.create_pod(_pods(["q"])[0])
        cached = rv("default")
    finally:
        server.server_close()
    assert first < every == again
    # no Service changed and no newer Service list was taken: a hit
    assert cached == again


def test_failed_status_write_still_requeues_the_pod():
    """A status write or existence check lost on the wire must not drop
    the pod between queues (the JAX scheduler's ``_record_failure``
    writes the status best effort too)."""
    from kubernetes_tpu_torch.scheduler.scheduler import Scheduler

    store = ClusterStore()
    sched = Scheduler.create(store)
    sched.start()
    try:
        store.create_pod(_pods(["p"])[0])
        (qpi,), _ = sched.queue.pop_batch(1, timeout=2.0)
        assert qpi.pod.name == "p"

        def lost(*args, **kwargs):
            raise ConnectionResetError("reset by peer")

        sched.client.patch_pod_condition = lost
        sched.client.get_pod = lost
        sched._record_failure(qpi, RuntimeError("HTTP 429"),
                              "SchedulerError", "", 0)
        assert [p.name for p in sched.queue.pending_pods()] == ["p"]
    finally:
        sched.stop()


def test_chaos_children_import_no_torch():
    """The chaos apiserver child's modules import nothing that imports
    torch or numpy."""
    code = ("import sys\n"
            "import kubernetes_tpu_torch.harness.chaos_rest\n"
            "import kubernetes_tpu_torch.apiserver.rest\n"
            "import kubernetes_tpu_torch.apiserver.store\n"
            "import kubernetes_tpu_torch.apiserver.wal\n"
            "import kubernetes_tpu_torch.harness.rest_perf\n"
            "bad = [m for m in ('torch', 'numpy', 'jax') if m in sys.modules]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   timeout=120)


def test_small_cell_survives_a_kill_and_a_restore():
    """A small seeded cell (4 nodes, 24 pods in 3 waves, the apiserver
    child SIGKILLed after wave 1 and restored from its WAL, fsynced)
    holds every invariant; it touches no device."""
    res = chaos_rest.run_chaos_rest(11, nodes=4, pods=24, waves=3,
                                    kill_at_wave=1, fsync=True,
                                    wait_timeout=60.0)
    assert res["ok"], res
    assert set(res["invariants"]) == {
        "all_bound", "bound_nodes_exist", "no_oversubscription",
        "wal_matches_live", "no_rv_regression"}
    st = res["stats"]
    assert st["kills"] == 1 and st["server_starts"] == 2
    assert st["kill_wave"] == 1 and st["faults_injected"] > 0
    assert st["child_imports_torch"] is False
