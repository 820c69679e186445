"""The noisy-tenant QoS row in the port against the JAX package's
``harness/qos.py``: the tenant tokens and the ``/debug/apf`` summary
over the same snapshots; one aggressor thread's requests, shape by
shape and seed by seed, against a stub server; the ``qos-tenant``
role's verdicts and a bulk ``ConfigMapList``'s APF width on both
packages' apiserver children; ``ConfigMap`` and ``Secret`` through both
wire codecs; a small noisy-tenant row on the CPU binding every pod; and
the store's namespace and mutation-count reads, which skip its lock.
Tolerance: exact equality (the row on the CPU is held by its counts)."""

import http.client
import http.server
import json
import multiprocessing as mp
import threading

import pytest

from kubernetes_tpu.api import serialization as jax_ser
from kubernetes_tpu.api import types as jax_types
from kubernetes_tpu.harness import qos as jax_qos
from kubernetes_tpu.harness import rest_perf as jax_rest_perf
from kubernetes_tpu_torch.api import serialization, types
from kubernetes_tpu_torch.harness import qos, rest_perf

SCHED = rest_perf.SCHEDULER_TOKEN
TENANT = "qos-tenant-0-token"


def test_tenant_tokens_match_reference():
    for n in (0, 1, 3, 7):
        assert qos.tenant_tokens(n) == jax_qos.tenant_tokens(n)


SYNTHETIC_APF = {"levels": {
    "system": {"dispatched_total": 40, "seats_dispatched_total": 52,
               "rejected": {}, "peak_executing_seats": 4, "capacity": 240},
    "workload": {"dispatched_total": 900, "seats_dispatched_total": 4100,
                 "rejected": {"queue-full": 12, "time-out": 3},
                 "peak_executing_seats": 240, "capacity": 240},
    "best-effort": {"dispatched_total": 0, "rejected": {"queue-full": 1}},
    "exempt": {}}}


@pytest.mark.parametrize("snap", [None, {}, {"levels": {}}, SYNTHETIC_APF],
                         ids=["none", "empty", "no-levels", "synthetic"])
def test_apf_summary_matches_reference(snap):
    assert qos._apf_summary(snap) == jax_qos._apf_summary(snap)


# ---------------------------------------------------------------------------
# the aggressor thread against a stub server


class _Stub(http.server.ThreadingHTTPServer):
    daemon_threads = True
    block_on_close = False

    def __init__(self, limit):
        super().__init__(("127.0.0.1", 0), _StubHandler)
        self.limit = limit
        self.seen = []
        self.stop = threading.Event()
        self.lock = threading.Lock()

    def handle_error(self, request, client_address):
        pass    # the watch herd drops its streams mid-read


class _StubHandler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):
        pass

    def _answer(self, body=b""):
        srv = self.server
        with srv.lock:
            n = len(srv.seen)
            if n >= srv.limit:
                srv.stop.set()
            # every third request is pushed back, so the 429 branch runs
            code = 429 if n % 3 == 2 else 200
        self.send_response(code)
        self.send_header("Content-Length", "2")
        self.end_headers()
        self.wfile.write(b"{}")

    def _note(self, body):
        with self.server.lock:
            self.server.seen.append((
                self.command, self.path, self.headers.get("Authorization"),
                self.headers.get("Accept"), self.headers.get("Content-Type"),
                self.headers.get("X-Kubernetes-Request-Items"), body))

    def do_GET(self):
        self._note(b"")
        self._answer()

    def do_POST(self):
        n = int(self.headers.get("Content-Length") or 0)
        self._note(self.rfile.read(n))
        self._answer()


def _transcript(mod, shape, seed, limit=6):
    stub = _Stub(limit)
    t = threading.Thread(target=stub.serve_forever, args=(0.01,),
                         daemon=True)
    t.start()
    stats = {"requests": 0, "throttled": 0}
    worker = threading.Thread(
        target=mod._aggressor_thread,
        args=("127.0.0.1", stub.server_address[1], "tok", shape, seed,
              stub.stop, stats, threading.Lock()), daemon=True)
    worker.start()
    worker.join(timeout=30.0)
    stub.shutdown()
    stub.server_close()
    assert not worker.is_alive()
    return stub.seen[:limit], stats


@pytest.mark.parametrize("shape", jax_qos.AGGRESSOR_SHAPES)
@pytest.mark.parametrize("seed", [7, 7008])
def test_aggressor_thread_requests_match_reference(shape, seed):
    assert qos.AGGRESSOR_SHAPES == jax_qos.AGGRESSOR_SHAPES
    got, got_stats = _transcript(qos, shape, seed)
    want, want_stats = _transcript(jax_qos, shape, seed)
    assert len(got) == 6
    assert got == want
    assert got_stats["throttled"] == want_stats["throttled"] > 0


# ---------------------------------------------------------------------------
# the qos-tenant role on both apiserver children


class _Child:
    """A package's REST-harness apiserver child, run on a thread over a
    pipe, as the harness spawns it."""

    def __init__(self, mod, extra_tokens):
        self.conn, child = mp.Pipe()
        self.thread = threading.Thread(
            target=mod._apiserver_main, args=(child, None, extra_tokens),
            daemon=True)
        self.thread.start()
        assert self.conn.poll(30.0)
        url = self.conn.recv()
        host, port = url.split("://", 1)[1].split(":")
        self.host, self.port = host, int(port)

    def call(self, method, path, body=None, token=TENANT, items=None):
        conn = http.client.HTTPConnection(self.host, self.port, timeout=10)
        headers = {"Authorization": f"Bearer {token}",
                   "Accept": "application/json"}
        data = None
        if body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        if items:
            headers["X-Kubernetes-Request-Items"] = str(items)
        conn.request(method, path, body=data, headers=headers)
        resp = conn.getresponse()
        raw = resp.read()
        conn.close()
        return resp.status, (json.loads(raw) if raw else {})

    def workload_level(self):
        code, snap = self.call("GET", "/debug/apf", token=SCHED)
        assert code == 200
        lv = snap["levels"]["workload"]
        return lv["dispatched_total"], lv["seats_dispatched_total"]

    def close(self):
        self.conn.send("stop")
        assert self.conn.poll(10.0)
        self.conn.recv()
        self.thread.join(timeout=10.0)


def _role_transcript(child):
    out = [child.call("GET", "/api/v1/pods")[0],
           child.call("GET", "/api/v1/nodes")[0],
           child.call("POST", "/api/v1/namespaces/default/configmaps",
                      {"metadata": {"name": "one"}})[0],
           child.call("POST", "/api/v1/namespaces/default/pods",
                      {"kind": "PodList", "items": [
                          {"metadata": {"name": "p"}}]}, items=1)[0],
           child.call("DELETE", "/api/v1/namespaces/default/configmaps/one")[0],
           child.call("GET", "/api/v1/secrets")[0]]
    d0, s0 = child.workload_level()
    items = [{"metadata": {"name": f"ld-{i}", "namespace": "default"}}
             for i in range(200)]
    code, body = child.call("POST", "/api/v1/configmaps",
                            {"kind": "ConfigMapList", "items": items},
                            items=200)
    d1, s1 = child.workload_level()
    # a taken name and a name twice in one list: positional 409s
    again = child.call("POST", "/api/v1/configmaps", {
        "kind": "ConfigMapList", "items": [
            {"metadata": {"name": n, "namespace": "default"}}
            for n in ("ld-0", "new-1", "new-1", "new-2")]}, items=4)
    listed = child.call("GET", "/api/v1/configmaps")[1]["items"]
    return out, (code, body.get("created"), body.get("failures")), \
        (d1 - d0, s1 - s0), again, \
        sorted(i["metadata"]["name"] for i in listed)


def test_qos_tenant_role_and_bulk_width_match_reference():
    tokens = qos.tenant_tokens(2)
    sides = [_Child(rest_perf, tokens), _Child(jax_rest_perf, tokens)]
    try:
        got, want = (_role_transcript(s) for s in sides)
    finally:
        for s in sides:
            s.close()
    assert got == want
    statuses, bulk, width, again, names = got
    assert statuses[:4] == [200, 200, 201, 403]
    assert bulk == (201, 200, [])
    dispatched, seats = width
    assert dispatched == 1 and seats > 1
    assert again[0] == 201 and again[1]["created"] == 2
    assert [f["index"] for f in again[1]["failures"]] == [0, 2]
    assert len(names) == 203


# ---------------------------------------------------------------------------
# the new kinds on the wire


def _objects(t):
    # explicit uids: a default one comes from a per-package counter
    meta = t.ObjectMeta(name="cfg", namespace="team-a", uid="u-cfg",
                        labels={"app": "web"})
    return [t.ConfigMap(metadata=meta, data={"k": "v", "empty": ""}),
            t.ConfigMap(metadata=t.ObjectMeta(uid="u-empty")),
            t.Secret(metadata=t.ObjectMeta(name="s", namespace="ns",
                                           uid="u-s"),
                     type="kubernetes.io/tls",
                     data={"tls.crt": "abc", "tls.key": "def"}),
            t.Secret(metadata=t.ObjectMeta(uid="u-s2"))]


def test_configmap_and_secret_round_trip_as_reference():
    assert {"ConfigMap", "Secret"} <= set(serialization.SCHEME)
    for got, want in zip(_objects(types), _objects(jax_types)):
        kind = type(got).__name__
        wire = serialization.to_wire(got)
        assert wire == jax_ser.to_wire(want)
        assert serialization.from_wire(wire, kind) == got
        assert serialization.to_wire(jax_ser.from_wire(wire, kind)) == wire


# ---------------------------------------------------------------------------
# the row on the CPU


def test_noisy_tenant_row_on_cpu_binds_every_pod():
    row = qos.run_noisy_tenant_qos(50, 200, tenants=2, max_batch=128,
                                   device="cpu")
    contended = row.pop("contended")
    assert row["server_pods_bound"] == 200
    assert contended.metrics["scheduler_bound"] == 200
    assert row["aggressors"]["reported"] == 2
    assert row["aggressors"]["requests"] > 0
    assert not row["aggressors"]["import_torch"]
    assert not contended.metrics["children_import_torch"]
    workload = row["apf"]["levels"]["workload"]
    assert workload["dispatched"] > 0
    assert row["solo_pods_per_sec"] > 0 and row["value"] > 0
    assert set(row) >= {"p99_ratio_vs_solo", "qos_ok", "p99_latency_ms",
                        "solo_p99_latency_ms", "metric", "apf"}


def test_admission_and_list_cache_reads_skip_the_store_lock():
    """Admission's reads (namespace, quotas, priority classes) and the
    list cache's mutation count do not queue behind a writer holding
    the store's lock (under bulk abuse
    that queue costs each item a writer's whole turn), and still see
    every committed write."""
    from kubernetes_tpu_torch.apiserver.store import ClusterStore

    store = ClusterStore()
    store.add_namespace(types.Namespace(metadata=types.ObjectMeta(name="a")))
    seq = store.kind_seq("ConfigMap")
    store.create_objects_bulk("ConfigMap", [types.ConfigMap(
        metadata=types.ObjectMeta(name=f"c{i}", namespace="a"))
        for i in range(3)])
    assert store.kind_seq("ConfigMap") == seq + 3
    held, done = threading.Event(), threading.Event()

    def writer():
        with store._lock:
            held.set()
            done.wait(10.0)

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    assert held.wait(10.0)
    try:
        out = []
        reader = threading.Thread(target=lambda: out.append(
            (store.get_namespace("a"), store.kind_seq("ConfigMap"),
             store.list_resource_quotas(), store.list_priority_classes())),
            daemon=True)
        reader.start()
        reader.join(2.0)
        assert not reader.is_alive(), "a read waited for the store's lock"
        assert out[0][0].metadata.name == "a" and out[0][1] == seq + 3
        assert out[0][2:] == ([], [])
    finally:
        done.set()
        t.join(10.0)
