"""The port's read tier against the JAX package's, on the CPU.

- ``FenceStateMachine``: the same transitions on the same lag sequences;
- ``ClusterStore.apply_replicated``: seeded subscription frames (resume
  overlap, equal-version repeats, older versions, key-only DELETED
  stubs, two kinds) parsed by each package's ``_parse_frame`` and
  applied to each package's store: equal applied lists and equal final
  (namespace, name, version) sets;
- ``attach_wal(preserve_log=True)``: a torn tail cut, the log appended
  to, ``wal_events_since`` equal after a restore;
- the subscription route: the same (type, kind, rv, name) frames from
  one seeded op sequence on a port owner and a JAX owner, the snapshot's
  leading version and objects, a resume through the WAL after the watch
  cache is compacted, a 410 once the WAL is compacted too;
- a read replica's 503s (read-only, fenced) and a fenced watch shed, on
  both packages' replicas;
- the port client's read routing (the JAX tests' assertions), the
  in-process mini cell's invariants, the owner-restart chaos cell over
  spawned processes, and the watch-herd row helpers against the JAX
  functions on fixed dicts.

Tolerance: exact equality everywhere.
"""

import http.client
import json
import os
import threading
import time

import numpy as np
import pytest

from kubernetes_tpu.api import types as jax_types
from kubernetes_tpu.apiserver import readtier as jax_readtier
from kubernetes_tpu.apiserver import rest as jax_rest
from kubernetes_tpu.apiserver import store as jax_store
from kubernetes_tpu.apiserver import wal as jax_wal
from kubernetes_tpu.harness import burst as jax_burst
from kubernetes_tpu.harness import watchherd as jax_herd
from kubernetes_tpu_torch.api import types
from kubernetes_tpu_torch.apiserver import readtier, rest, store, wal
from kubernetes_tpu_torch.client.restcluster import RestClusterClient
from kubernetes_tpu_torch.harness import burst
from kubernetes_tpu_torch.harness import watchherd as herd

SIDES = {
    "jax": dict(readtier=jax_readtier, rest=jax_rest, store=jax_store,
                wal=jax_wal, burst=jax_burst, types=jax_types),
    "port": dict(readtier=readtier, rest=rest, store=store, wal=wal,
                 burst=burst, types=types),
}


class Side:
    def __init__(self, name):
        self.name = name
        self.__dict__.update(SIDES[name])


# ---------------------------------------------------------------------------
# the fence's hysteresis


def _lag_sequences():
    rng = np.random.default_rng(19)
    seqs = {
        "trip": (0.1, 3, 5, [0.2, 0.2, 0.2]),
        "streak_broken": (0.1, 3, 5, [0.2, 0.2, 0.05, 0.2, 0.2, 0.2]),
        "clear_needs_headroom": (0.1, 1, 3, [0.5, 0.04, 0.04, 0.09, 0.04,
                                             0.04, 0.04]),
        "refence": (0.1, 1, 2, [0.5, 0.01, 0.01, 0.5]),
    }
    for i in range(4):
        budget = float(rng.uniform(0.05, 0.6))
        lags = rng.exponential(budget, size=60).round(4).tolist()
        seqs[f"seeded{i}"] = (budget, int(rng.integers(1, 4)),
                              int(rng.integers(1, 6)), lags)
    return seqs


LAGS = _lag_sequences()


@pytest.mark.parametrize("case", sorted(LAGS))
def test_fence_transitions_match_the_reference(case):
    budget, trip, clear, lags = LAGS[case]
    runs = []
    for mod in (jax_readtier, readtier):
        f = mod.FenceStateMachine(lag_budget_s=budget, trip_after=trip,
                                  clear_after=clear)
        runs.append(([f.observe(x) for x in lags], f.fenced, f.fences))
    assert runs[0] == runs[1]
    if case == "clear_needs_headroom":
        assert runs[1][0][-1] is False
    if case == "refence":
        assert runs[1][2] == 2


# ---------------------------------------------------------------------------
# apply_replicated over seeded frames


def _pod_wire(i, rv, node=""):
    spec = {"containers": [{"name": "c", "image": "registry/fake:1",
                            "resources": {"requests": {"cpu": "100m"}}}]}
    if node:
        spec["nodeName"] = node
    return {"kind": "Pod", "apiVersion": "v1",
            "metadata": {"name": f"p{i}", "namespace": f"ns{i % 3}",
                         "uid": f"u{i}", "resourceVersion": str(rv)},
            "spec": spec}


def _node_wire(i, rv):
    return {"kind": "Node", "apiVersion": "v1",
            "metadata": {"name": f"n{i}", "resourceVersion": str(rv)},
            "status": {"capacity": {"cpu": "8", "memory": "16Gi",
                                    "pods": "110"}}}


def _frames(seed):
    """Batches of subscription lines: creates, binds and deletes (a
    third of them key-only stubs) at rising versions, each batch after
    the first opening with a replay of the previous batch's tail (a
    resumed stream's overlap) and carrying an equal-version repeat and
    an older version."""
    rng = np.random.default_rng(seed)
    rv = 0
    live = {}
    batches = []
    prev = []
    for _ in range(6):
        batch = list(prev[-3:])
        for _ in range(int(rng.integers(8, 14))):
            rv += 1
            roll = rng.random()
            if roll < 0.15:
                doc = {"type": "ADDED", "kind": "Node",
                       "object": _node_wire(int(rng.integers(0, 4)), rv)}
            elif roll < 0.7 or not live:
                i = int(rng.integers(0, 20))
                node = f"n{int(rng.integers(0, 4))}" \
                    if i in live and rng.random() < 0.5 else ""
                doc = {"type": "MODIFIED" if i in live else "ADDED",
                       "kind": "Pod", "object": _pod_wire(i, rv, node)}
                live[i] = rv
            else:
                i = sorted(live)[int(rng.integers(0, len(live)))]
                del live[i]
                doc = {"type": "DELETED", "kind": "Pod"}
                if rng.random() < 0.34:
                    doc["key"] = [f"ns{i % 3}", f"p{i}"]
                else:
                    doc["object"] = _pod_wire(i, rv)
            doc["rv"] = rv
            doc["commitTs"] = 1000.0 + rv
            batch.append(doc)
        batch.append(dict(batch[-1]))                 # equal version
        old = dict(batch[len(batch) // 2])
        old["rv"] = max(1, old["rv"] - 5)             # an older version
        if "object" in old:
            obj = json.loads(json.dumps(old["object"]))
            obj["metadata"]["resourceVersion"] = str(old["rv"])
            old["object"] = obj
        batch.append(old)
        prev = batch
        batches.append([json.dumps(d).encode() for d in batch])
    return batches


def _replicate(side, batches):
    mirror = side.store.ClusterStore()
    applied = []
    for lines in batches:
        parse = side.readtier._parse_frame
        events = [parse(line, None) if side.name == "jax" else parse(line)
                  for line in lines]
        # one frame a call, as the replication client applies them; each
        # read at once (the reference stamps a delete's version on the
        # stored object, which an earlier event may still hold)
        for one in events:
            for e in mirror.apply_replicated([one] if one else []):
                applied.append((e.type, e.kind,
                                int(e.obj.metadata.resource_version),
                                e.obj.metadata.namespace or "",
                                e.obj.metadata.name, e.ts))
    pods = sorted((p.metadata.namespace, p.metadata.name,
                   int(p.metadata.resource_version))
                  for p in mirror.list_pods())
    nodes = sorted((n.metadata.name, int(n.metadata.resource_version))
                   for n in mirror.list_nodes())
    return applied, pods, nodes, mirror.current_rv()


@pytest.mark.parametrize("seed", [3, 11, 19])
def test_apply_replicated_matches_the_reference(seed):
    batches = _frames(seed)
    ref = _replicate(Side("jax"), batches)
    got = _replicate(Side("port"), batches)
    assert got == ref
    applied = got[0]
    assert len({(k, ns, n, rv) for _, k, rv, ns, n, _ in applied}) \
        == len(applied)          # no event applied twice
    assert any(t == "DELETED" for t, *_ in applied)


def test_apply_replicated_keeps_committed_events_and_counts_binds():
    mirror = store.ClusterStore()
    seen = []
    handle = mirror.watch(seen.extend)
    try:
        mk = readtier._parse_frame
        mirror.apply_replicated([mk(json.dumps(
            {"type": "ADDED", "kind": "Pod", "rv": 4,
             "object": _pod_wire(1, 4, node="n0")}).encode())])
        assert mirror.count_bound() == 1
        mirror.apply_replicated([mk(json.dumps(
            {"type": "DELETED", "kind": "Pod", "rv": 7,
             "key": ["ns1", "p1"]}).encode())])
        assert mirror.count_bound() == 0
        added, deleted = seen
        # the delete is announced on a copy at its own version
        assert int(added.obj.metadata.resource_version) == 4
        assert int(deleted.obj.metadata.resource_version) == 7
        assert deleted.obj.spec.node_name == "n0"
        assert mirror.current_rv() == 7
    finally:
        handle.stop()


# ---------------------------------------------------------------------------
# the WAL's preserve_log


def _wal_run(side, root):
    d = os.path.join(root, side.name)
    os.makedirs(d)
    st = side.store.ClusterStore()
    handle = side.wal.attach_wal(st, d)
    pods = side.burst.make_burst_pods(12, name_prefix="w-",
                                      uid_prefix="wu-")
    for p in pods[:8]:
        st.create_pod(p)
    for p in pods[:3]:
        st.delete_pod(p.namespace, p.metadata.name)
    handle.drain()
    handle.close()
    log = os.path.join(d, "wal.jsonl")
    with open(log, "ab") as f:
        f.write(b'{"t": "PUT", "k": "Pod", "rv": 99, "o": {"kind"')
    restored = side.wal.restore_store(d)
    handle = side.wal.attach_wal(restored, d, preserve_log=True)
    for p in pods[8:]:
        restored.create_pod(p)
    restored.delete_pod(pods[5].namespace, pods[5].metadata.name)
    handle.drain()
    handle.close()
    with open(log, "rb") as f:
        data = f.read()
    covered, entries = side.wal.wal_events_since(d, 4)
    shape = [(e["t"], e["k"], e["rv"], e.get("n") or e["o"]["metadata"]
              ["name"]) for e in entries]
    final = sorted((p.metadata.name, int(p.metadata.resource_version))
                   for p in side.wal.restore_store(d).list_pods())
    return data, covered, shape, final


def test_preserve_log_repairs_the_tail_and_matches_the_reference(tmp_path):
    ref = _wal_run(Side("jax"), str(tmp_path))
    got = _wal_run(Side("port"), str(tmp_path))
    data, covered, shape, final = got
    assert data.endswith(b"\n") and b'"o": {"kind"\n' not in data
    assert b'"rv": 99' not in data          # the torn line was cut
    assert covered and shape
    assert (covered, shape, final) == ref[1:]
    # the appends after the restore continue the numbering
    assert [rv for _, _, rv, _ in shape] == sorted(rv for _, _, rv, _
                                                   in shape)


# ---------------------------------------------------------------------------
# the subscription route


def _ops(side, st, rng_seed=5):
    """One seeded op sequence: nodes, creates, binds, deletes."""
    rng = np.random.default_rng(rng_seed)
    for i in range(3):
        st.add_node(side.types.Node.from_dict(_node_wire(i, 0)))
    pods = side.burst.make_burst_pods(16, name_prefix="s-",
                                      uid_prefix="su-")
    live = []
    for p in pods:
        st.create_pod(p)
        live.append(p)
        if rng.random() < 0.3:
            q = live.pop(int(rng.integers(0, len(live))))
            st.delete_pod(q.namespace, q.metadata.name)
    return len(live)


def _get(url, path, timeout=10.0):
    host, port = url.split("//", 1)[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    conn.request("GET", path)
    return conn, conn.getresponse()


def _frame_shape(doc):
    obj = doc.get("object")
    name = obj["metadata"]["name"] if obj else doc["key"][1]
    return (doc["type"], doc["kind"], doc["rv"], name)


def _read_frames(resp, n):
    out = []
    while len(out) < n:
        line = resp.readline()
        if not line:
            break
        if line.strip():
            out.append(_frame_shape(json.loads(line)))
    return out


class _Owner:
    def __init__(self, side, wal_dir=None):
        self.side = side
        self.store = side.store.ClusterStore()
        self.wal = None
        if wal_dir is not None:
            os.makedirs(wal_dir)
            self.wal = side.wal.attach_wal(self.store, wal_dir)
        self.server = side.rest.APIServer(store=self.store).start()
        self.server.wal_dir = wal_dir
        _ops(side, self.store)
        if self.wal is not None:
            self.wal.drain()

    def stop(self):
        self.server.shutdown_server()
        if self.wal is not None:
            self.wal.close()


@pytest.fixture(scope="module")
def owners(tmp_path_factory):
    root = tmp_path_factory.mktemp("owners")
    out = {name: _Owner(Side(name), str(root / name))
           for name in ("jax", "port")}
    yield out
    for o in out.values():
        o.stop()


def test_subscription_frames_match_the_reference(owners):
    frames = {}
    for name, o in owners.items():
        n = o.store.current_rv()
        conn, resp = _get(o.server.url,
                          "/api/v1/subscription?resourceVersion=0")
        assert resp.status == 200
        frames[name] = _read_frames(resp, n)
        conn.close()
    assert frames["port"] == frames["jax"]
    assert frames["port"] and any(t == "DELETED"
                                  for t, *_ in frames["port"])


def test_subscription_snapshot_matches_the_reference(owners):
    snaps = {}
    for name, o in owners.items():
        conn, resp = _get(o.server.url, "/api/v1/subscription?snapshot=1")
        assert resp.status == 200
        head = json.loads(resp.readline())
        objs = []
        while True:
            line = resp.readline()
            if not line or not line.strip():
                break
            batch = json.loads(line)
            objs += [(batch["kind"], w["metadata"]["name"],
                      w["metadata"]["resourceVersion"])
                     for w in batch["objects"]]
        conn.close()
        snaps[name] = (head["rv"], sorted(objs))
    assert snaps["port"] == snaps["jax"]
    assert snaps["port"][0] == owners["port"].store.current_rv()


def test_subscription_resumes_through_the_wal_then_410s(owners):
    resumed, gone = {}, {}
    for name, o in owners.items():
        o.server.watch_cache.compact(keep_last=1)
        top = o.store.current_rv()
        conn, resp = _get(o.server.url,
                          "/api/v1/subscription?resourceVersion=4")
        assert resp.status == 200
        resumed[name] = _read_frames(resp, top - 4)
        conn.close()
        o.wal.snapshot()                  # the log truncated as well
        o.server.watch_cache.compact(keep_last=1)
        conn, resp = _get(o.server.url,
                          "/api/v1/subscription?resourceVersion=4")
        gone[name] = resp.status
        resp.read()
        conn.close()
    assert resumed["port"] == resumed["jax"]
    assert [rv for _, _, rv, _ in resumed["port"]] == list(
        range(5, owners["port"].store.current_rv() + 1))
    assert gone == {"jax": 410, "port": 410}


# ---------------------------------------------------------------------------
# a replica's 503s and the fenced watch shed


def _replica_verdicts(side):
    st = side.store.ClusterStore()
    owner = side.rest.APIServer(store=st).start()
    rep = side.readtier.ReadReplica(owner.url, replica_id=f"v-{side.name}")
    try:
        for p in side.burst.make_burst_pods(3, name_prefix="ro-",
                                            uid_prefix="rou-"):
            st.create_pod(p)
        rep.start(seed_timeout=10.0)
        host, port = rep.url.split("//", 1)[1].split(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=10)
        body = json.dumps(_pod_wire(99, 0)).encode()
        conn.request("POST", "/api/v1/namespaces/default/pods", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        post = (resp.status, resp.headers.get("X-Replica-ReadOnly"),
                json.loads(resp.read())["reason"])
        # the connection survives the refusal: the next read is served
        conn.request("GET", "/api/v1/pods",
                     headers={"Accept": "application/json"})
        resp = conn.getresponse()
        listed = (resp.status, len(json.loads(resp.read())["items"]))
        wconn, wresp = _get(rep.url, "/api/v1/pods?watch=1&"
                            "resourceVersion=" + str(st.current_rv()))
        assert wresp.status == 200
        rep.server.fenced.set()
        t0 = time.monotonic()
        while wresp.readline():
            pass                       # the stream ends: shed
        shed_s = time.monotonic() - t0
        wconn.close()
        conn.request("GET", "/api/v1/pods")
        resp = conn.getresponse()
        fenced = (resp.status, resp.headers.get("X-Replica-Fenced"),
                  json.loads(resp.read())["reason"])
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        resp.read()
        health = resp.status
        conn.close()
        return post, listed, fenced, health, shed_s
    finally:
        rep.stop()
        owner.shutdown_server()


def test_replica_refusals_and_fence_shed_match_the_reference():
    ref = _replica_verdicts(Side("jax"))
    got = _replica_verdicts(Side("port"))
    assert got[:4] == ref[:4]
    assert got[0] == (503, "1", "ReadOnlyReplica")
    assert got[1] == (200, 3)
    assert got[2] == (503, "1", "ReplicaFenced")
    assert got[3] == 200
    assert got[4] < 5.0


# ---------------------------------------------------------------------------
# the port client's read routing (the JAX package's assertions)


def _seed(st, n, prefix):
    for p in burst.make_burst_pods(n, name_prefix=prefix,
                                   uid_prefix=prefix + "u"):
        st.create_pod(p)


@pytest.mark.parametrize("fault", ["none", "kill", "fence"])
def test_client_reads_ride_the_replica_and_reroute(fault):
    st = store.ClusterStore()
    owner = rest.APIServer(store=st).start()
    rep = readtier.ReadReplica(owner.url, replica_id=f"rt-{fault}")
    client = None
    try:
        _seed(st, 4, f"rr{fault}-")
        rep.start(seed_timeout=10.0)
        client = RestClusterClient(owner.url)
        client.set_read_replicas({0: [rep.url]})
        assert len(client.list_pods()) == 4
        assert client.replica_reads >= 1
        if fault == "kill":
            rep.kill()
        elif fault == "fence":
            rep.server.fenced.set()
        if fault != "none":
            # the same call marks the replica down and reads from the
            # owner, within its retry budget
            assert len(client.list_pods()) == 4
            assert client.replica_reroutes >= 1
        else:
            assert client.replica_reroutes == 0
    finally:
        if client is not None:
            client._drop_conn()
        rep.stop()
        owner.shutdown_server()


def test_topology_document_installs_replica_routing():
    from kubernetes_tpu_torch.apiserver.partition import PartitionTopology

    st = store.ClusterStore()
    owner = rest.APIServer(store=st).start()
    rep = readtier.ReadReplica(owner.url, replica_id="rt-topo")
    client = None
    try:
        _seed(st, 2, "tp-")
        rep.start(seed_timeout=10.0)
        topo = readtier.advertise_replicas(
            PartitionTopology.default(1, urls=[owner.url]), 0, [rep.url])
        assert topo.epoch == 2 and topo.replicas == {0: (rep.url,)}
        owner.install_topology(topo)
        client = RestClusterClient(owner.url)
        client.refresh_topology()
        assert len(client.list_pods()) == 2
        assert client.replica_reads >= 1
        # writes still go to the owner
        client.create_pod(burst.make_burst_pods(
            1, name_prefix="tw-", uid_prefix="twu-")[0])
        assert len(st.list_pods()) == 3
    finally:
        if client is not None:
            client._drop_conn()
        rep.stop()
        owner.shutdown_server()


# ---------------------------------------------------------------------------
# the subscription client's resume (the JAX package's cases)


def _truth(st):
    return sorted((p.namespace, p.metadata.name,
                   int(p.metadata.resource_version))
                  for p in st.list_pods())


def _wait_match(mirror, st, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if _truth(mirror) == _truth(st):
            return True
        time.sleep(0.02)
    return False


@pytest.mark.parametrize("ghost", [False, True])
def test_severed_subscription_resumes_from_its_cursor(ghost):
    st = store.ClusterStore()
    owner = rest.APIServer(store=st).start()
    mirror = store.ClusterStore()
    repl = readtier.ReplicationClient(owner.url, mirror,
                                      replica_id=f"tr-{ghost}")
    try:
        repl.start()
        assert repl.seeded.wait(10.0)
        _seed(st, 5, "sr-")
        assert _wait_match(mirror, st)
        cursor = repl.cursor
        owner.sever_connections()
        if ghost:
            # created and deleted inside the outage: not resurrected
            (g,) = burst.make_burst_pods(1, name_prefix="ghost-",
                                         uid_prefix="ghostu-")
            st.create_pod(g)
            st.delete_pod(g.namespace, g.metadata.name)
        _seed(st, 5, "sr2-")
        assert _wait_match(mirror, st)
        assert repl.resumes >= 1 and repl.reseeds == 0
        assert repl.cursor > cursor
        assert not any(p.metadata.name.startswith("ghost-")
                       for p in mirror.list_pods())
    finally:
        repl.stop()
        owner.shutdown_server()


def test_a_stalled_replica_is_cut_without_losing_an_event(monkeypatch):
    """A replica whose stream stalls while the owner commits a burst
    larger than the subscription's queue is cut: it gets a gap-free
    prefix, resumes from its cursor, and its mirror ends equal to the
    owner. Dropping any queued frame instead leaves the mirror short."""
    monkeypatch.setattr(rest, "SUBSCRIPTION_QUEUE_FRAMES", 64)
    flowing = threading.Event()
    flowing.set()
    held = threading.Event()
    write_chunk = rest._Handler._write_chunk

    def stalled(self, body):
        if not flowing.is_set():
            held.set()
            flowing.wait(30.0)
        write_chunk(self, body)

    monkeypatch.setattr(rest._Handler, "_write_chunk", stalled)
    st = store.ClusterStore()
    owner = rest.APIServer(store=st).start()
    mirror = store.ClusterStore()
    repl = readtier.ReplicationClient(owner.url, mirror, replica_id="stall")
    try:
        repl.start()
        assert repl.seeded.wait(10.0)
        _seed(st, 5, "st-")
        assert _wait_match(mirror, st)
        flowing.clear()
        _seed(st, 1, "sth-")
        assert held.wait(10.0)          # the writer is stuck in a write
        st.create_pods(burst.make_burst_pods(100, name_prefix="stb-",
                                             uid_prefix="stbu-"))
        assert owner.watch_drops == 1
        flowing.set()
        assert _wait_match(mirror, st)
        assert repl.resumes >= 1 and repl.reseeds == 0
        assert owner.watch_drops == 1
    finally:
        flowing.set()
        repl.stop()
        owner.shutdown_server()


# ---------------------------------------------------------------------------
# the in-process mini cell


@pytest.fixture(scope="module")
def mini_cell():
    return herd.run_readtier_mini_cell()


def test_mini_cell_converges_with_nothing_lost(mini_cell):
    assert mini_cell["unconverged"] == 0
    assert mini_cell["lost_events"] == 0
    assert mini_cell["truth_objects"] > 0
    assert mini_cell["delivered_total"] > 0


def test_mini_cell_relists_stay_with_the_killed_replica(mini_cell):
    assert mini_cell["relists_on_killed"] >= 1
    assert mini_cell["relists_beyond_killed"] == 0
    assert mini_cell["killed_informers"] > 0


def test_mini_cell_survivor_matches_the_owner(mini_cell):
    assert mini_cell["replica_truth_match"] is True
    assert mini_cell["survivor_stats"]["reseeds"] == 0


def test_owner_restart_cell_resumes_through_the_wal():
    """Spawned owner, two replicas and a herd; the owner SIGKILLed and
    restarted from its preserved log."""
    cell = herd.run_readtier_cell(16, scenario="owner_restart",
                                  informers=8, creates=40, qps=80.0)
    assert cell["ok"], cell["failure"]
    assert cell["lost_events"] == 0 and cell["relists"] == 0
    assert cell["resumes"] >= 1 and cell["reseeds"] == 0


def test_unknown_readtier_scenario_is_refused():
    with pytest.raises(ValueError, match="unknown readtier scenario"):
        herd.run_readtier_cell(1, scenario="bogus")


# ---------------------------------------------------------------------------
# the row helpers against the JAX functions


SNAPS = [
    {"hash": "aa", "delivered": 40, "dup_suppressed": 0, "relists": 0,
     "reroutes": 0, "errors": 0, "primary": 0},
    {"hash": "aa", "delivered": 38, "dup_suppressed": 3, "relists": 1,
     "reroutes": 1, "errors": 1, "primary": 1},
    {"hash": "bb", "delivered": 12, "dup_suppressed": 0, "relists": 0,
     "reroutes": 2, "errors": 2, "primary": None},
]


def _arm(**over):
    res = {"replicas": 4, "informers": 64, "streams": 68,
           "writer": {"events": 150, "offered_qps": 20.0,
                      "achieved_qps": 19.7},
           "fanout_events_per_s": 1234.5, "delivered_total": 9600,
           "lost_events": 0, "unconverged": 0, "dup_suppressed": 0,
           "relists": 0, "reroutes": 0, "replica_reads": 2,
           "convergence_wall_s": 7.8, "owner_cpu_s": 1.9,
           "fanout_per_owner_cpu_s": 5052.6,
           "replication_lag_p99_ms": 41.2, "fences": 0,
           "state_hash": "0123456789abcdef", "truth_rv": 181}
    res.update(over)
    return res


ARMS = {"clean": {}, "unconverged": {"unconverged": 2},
        "dups": {"dup_suppressed": 5}, "relists": {"relists": 1},
        "fences": {"fences": 1}, "no_reads": {"replica_reads": 0},
        "lag": {"replication_lag_p99_ms": 731.0},
        "no_replicas": {"replicas": 0, "replica_reads": 0}}


def test_state_hash_and_aggregate_match_the_reference():
    items = [("ns1", "b", 7), ("ns0", "a", 3), ("ns1", "a", 9)]
    assert herd._state_hash(items) == jax_herd._state_hash(items)
    assert herd._state_hash(items) == herd._state_hash(items[::-1])
    got = herd._aggregate([dict(s) for s in SNAPS], "aa")
    assert got == jax_herd._aggregate([dict(s) for s in SNAPS], "aa")
    assert got["lost_events"] == 1


@pytest.mark.parametrize("case", sorted(ARMS))
def test_arm_invariants_and_row_match_the_reference(case):
    res = _arm(**ARMS[case])
    got = herd._arm_invariants(res, 0.5)
    assert got == jax_herd._arm_invariants(res, 0.5)
    assert got[0] == (case in ("clean", "no_replicas"))
    assert herd._arm_row(res, 16, 120, 20.0, 0.5) == \
        jax_herd._arm_row(res, 16, 120, 20.0, 0.5)


@pytest.mark.parametrize("ok", [True, False])
def test_cell_row_matches_the_reference(ok):
    cell = {"seed": 16, "profile": "lag_fence", "ok": ok,
            "failure": "" if ok else "lagging replica never fenced",
            "informers": 48, "replicas": 2, "events_committed": 288,
            "lost_events": 0, "relists": 24, "fences": int(ok),
            "replica_stats": [{"replica": "r0"}]}
    assert herd._cell_row(dict(cell)) == jax_herd._cell_row(dict(cell))
    assert "replica_stats" not in herd._cell_row(dict(cell))


def test_resume_after_an_owner_outage_stays_within_the_lag_budget():
    """The owner's server gone for 1.65 s, then back on the same port and
    writing at once: the replica resumes from its cursor and replays the
    window within its lag budget, so it does not fence."""
    st = store.ClusterStore()
    owner = rest.APIServer(store=st).start()
    port = owner.server_address[1]
    mirror = store.ClusterStore()
    repl = readtier.ReplicationClient(owner.url, mirror, replica_id="out")
    try:
        repl.start()
        assert repl.seeded.wait(10.0)
        _seed(st, 3, "before-")
        assert _wait_match(mirror, st)
        owner.shutdown_server()
        owner.sever_connections()
        owner.server_close()
        time.sleep(1.65)
        owner = rest.APIServer(store=st, port=port).start()
        for p in burst.make_burst_pods(60, name_prefix="after-",
                                       uid_prefix="afteru-"):
            st.create_pod(p)
            time.sleep(0.01)
        assert _wait_match(mirror, st)
        assert repl.resumes >= 1 and repl.reseeds == 0
        assert repl.fence.fences == 0, repl.stats()
        assert repl.max_lag_s < readtier.DEFAULT_LAG_BUDGET_S
    finally:
        repl.stop()
        owner.shutdown_server()
