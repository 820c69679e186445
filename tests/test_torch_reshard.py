"""The port's elastic control plane, write side, against the JAX package's
(the JAX ``tests/test_reshard.py``'s REST, coordinator, epoch and driver
cases, and its chaos cells):

- the server's reshard surface: the live topology document, installs
  whose epochs only increase, the 429 of a frozen slot (Retry-After and
  no epoch) and of a moved slot (``X-Partition-Epoch``);
- ``apiserver/reshard.py``'s ``ReshardCoordinator``: a slot move and a
  rolled-back move (a destination whose adopt fails), with the same
  moved counts, epochs and per-server pods as the JAX coordinator;
- the elastic client: the version watchdog reset for exactly the
  restarted partition across a failover's epoch bump, and a watch that
  keeps delivering through the seam;
- ``autoscaler/partitions.py``'s ``InprocElasticDriver``: buy, split and
  retire give the JAX driver's topologies and pod placements;
  ``RestElasticDriver``'s observation of a live fleet;
- the midstorm, rebalance and sigkill chaos cells (one seed each; the
  sigkill cell SIGKILLs a spawned WAL-backed partition server mid
  migration and restores it): every invariant holds in both packages;
- the WAL's synchronous append: an acknowledged write, a bulk create's
  included, is in the log when the call returns, and a SIGKILLed
  apiserver child's acknowledged pods are all restored, by either
  package's ``restore_store``.
- the drain (the port's own; the JAX freeze answers at once): a freeze
  answers only after a bulk create the gate let through before it has
  committed, and a freeze whose writes outlive its budget aborts
  thawed.

Tolerance: exact equality; the chaos cells race writers against
migrations, so they compare invariants and verdicts, not placements."""

import importlib
import json
import multiprocessing as mp
import os
import threading
import time

import pytest

PKGS = ("kubernetes_tpu", "kubernetes_tpu_torch")


def _mod(root, path):
    return importlib.import_module(f"{root}.{path}")


def _pod(root, name, ns="default"):
    p = _mod(root, "testing").MakePod().name(name).uid(
        f"u-{ns}-{name}").req({"cpu": "100m", "memory": "50Mi"}).obj()
    p.metadata.namespace = ns
    return p


def _node(root, name):
    return _mod(root, "testing").MakeNode().name(name).capacity(
        {"cpu": "4", "memory": "8Gi", "pods": "110"}).obj()


def _spin(root, n):
    APIServer = _mod(root, "apiserver.rest").APIServer
    ClusterStore = _mod(root, "apiserver.store").ClusterStore
    Topology = _mod(root, "apiserver.partition").PartitionTopology
    servers = [APIServer(store=ClusterStore(), partition=(i, n)).start()
               for i in range(n)]
    urls = [s.url for s in servers]
    topo = Topology.default(n, urls=urls)
    for s in servers:
        s.install_topology(topo)
    return servers, urls


def _shutdown(servers):
    for s in servers:
        s.shutdown_server()


# ---------------------------------------------------------------------------
# the server's surface


def _surface_script(root):
    """The topology document, a run of installs, and the 429s of a frozen
    and a moved slot, as one package's server answers them."""
    import http.client as hc

    Client = _mod(root, "client.restcluster").RestClusterClient
    servers, urls = _spin(root, 2)
    client = Client(urls[0], partition_urls=urls)
    out = {}
    try:
        code, doc = client._request("GET", "/api/v1/partitiontopology")
        out["doc"] = (code, {k: v for k, v in doc.items() if k != "urls"},
                      doc["urls"] == urls)
        topo = type(servers[0].partition_topology).from_dict(doc)
        out["installs"] = [
            servers[0].install_topology(topo),
            servers[0].install_topology(topo.evolve()),
            servers[0].install_topology(topo.evolve()),
            servers[0].install_topology(topo.evolve().evolve()),
            servers[0].partition_topology.epoch]
        for s in servers:   # one epoch everywhere again
            s.install_topology(servers[0].partition_topology.evolve())
        topo = servers[1].partition_topology
        slot = topo.slot_of("Pod", "gate-ns", None)
        owner = topo.owner[slot]
        host, port = urls[owner].split("://")[1].split(":")
        wire = {"kind": "Pod", "metadata": {"name": "gated",
                                            "namespace": "gate-ns"},
                "spec": {}}

        def post():
            conn = hc.HTTPConnection(host, int(port), timeout=10)
            try:
                conn.request("POST", "/api/v1/namespaces/gate-ns/pods",
                             json.dumps(wire),
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                body = json.loads(resp.read())
                return (resp.status, float(resp.getheader("Retry-After")
                                           or 0) > 0,
                        resp.getheader("X-Partition-Epoch"),
                        resp.getheader("X-Kubernetes-PF-PriorityLevel"),
                        body["message"])
            finally:
                conn.close()

        servers[owner].frozen_slots[slot] = (time.monotonic() + 3.0, 3.0)
        out["frozen"] = post()
        out["frozen_admin"] = client._request(
            "GET", "/debug/partition", partition=owner)[1]["frozen"]
        servers[owner].frozen_slots.clear()
        moved = topo.evolve(owner=[1 - o if s == slot else o
                                   for s, o in enumerate(topo.owner)])
        out["moved_install"] = servers[owner].install_topology(moved)
        out["moved"] = post()
        out["moved_epoch"] = moved.epoch
        out["unfrozen_write"] = client._request(
            "POST", "/api/v1/namespaces/other-ns/pods",
            {"kind": "Pod", "metadata": {"name": "free",
                                         "namespace": "other-ns"},
             "spec": {}}, body_binary=False,
            partition=servers[0].partition_topology.partition_of(
                "Pod", "other-ns", None))[0]
    finally:
        client._drop_conn()
        _shutdown(servers)
    return out


def test_reshard_surface_answers_as_the_reference():
    jax, port = (_surface_script(root) for root in PKGS)
    assert port == jax
    code, doc, urls_ok = port["doc"]
    assert code == 200 and urls_ok and doc["epoch"] == 1
    assert doc["partition"] == 0 and doc["partitions"] == 2
    assert port["installs"] == [False, True, False, True, 3]
    status, retry, epoch, level, _ = port["frozen"]
    assert (status, retry, epoch, level) == (429, True, None, "reshard")
    assert port["frozen_admin"]
    status, _, epoch, _, message = port["moved"]
    assert status == 429 and int(epoch) == port["moved_epoch"]
    assert "no longer owns" in message
    assert port["unfrozen_write"] == 201


# ---------------------------------------------------------------------------
# the coordinator


def _coordinator_script(root):
    reshard = _mod(root, "apiserver.reshard")
    Client = _mod(root, "client.restcluster").RestClusterClient
    servers, urls = _spin(root, 2)
    client = Client(urls[0], partition_urls=urls)
    out = {}
    try:
        assert client.enable_topology(poll_interval=0)
        for i in range(10):
            client.create_object("Pod", _pod(root, f"m{i}", ns="mv-ns"))
        co = reshard.ReshardCoordinator(client, freeze_eta=3.0,
                                        evict_grace_s=0.0)
        topo = co.fetch_topology()
        slot = topo.slot_of("Pod", "mv-ns", None)
        src = topo.owner[slot]
        report = co.move_slots({slot: 1 - src})
        out["move"] = {k: report[k] for k in
                       ("reason", "epoch", "moved_objects",
                        "frozen_slots")}
        out["after_move"] = (
            co.fetch_topology().epoch, client.topology_epoch,
            [sorted(p.metadata.name for p in s.store.list_pods("mv-ns"))
             for s in servers])
        # rollback: the destination's adopt fails after the copy
        topo2 = co.fetch_topology()
        slot2 = topo2.slot_of("Pod", "mv2-ns", None)
        src2 = topo2.owner[slot2]
        dest2 = 1 - src2
        for i in range(5):
            client.create_object("Pod", _pod(root, f"r{i}", ns="mv2-ns"))
        orig = co._admin

        def failing(p, payload):
            if p == dest2 and payload.get("op") == "adopt":
                raise reshard.ReshardError("injected: destination "
                                           "unreachable")
            return orig(p, payload)

        co._admin = failing
        with pytest.raises(reshard.ReshardError) as err:
            co.move_slots({slot2: dest2})
        co._admin = orig
        out["rollback"] = (
            err.value.committed, co.fetch_topology().epoch,
            [sorted(p.metadata.name for p in s.store.list_pods("mv2-ns"))
             for s in servers],
            [sorted(s.frozen_slots) for s in servers])
        # the thaw happened: a write after the rollback lands
        client.create_object("Pod", _pod(root, "thawed", ns="mv2-ns"))
        out["thawed"] = len(servers[src2].store.list_pods("mv2-ns"))
        out["stats"] = [{k: st[k] for k in ("partition", "alive", "epoch",
                                            "objects")}
                        for st in co.stats()]
        # retire a partition: its slots drain to the survivor
        rep = co.retire(1)
        out["retire"] = (rep["reason"], rep["epoch"], rep["moved_objects"],
                         [len(s.store.list_pods()) for s in servers],
                         sorted(co.fetch_topology().retired))
    finally:
        client._stop_watches()
        client._drop_conn()
        _shutdown(servers)
    return out


def test_coordinator_move_rollback_and_retire_equal_the_reference():
    jax, port = (_coordinator_script(root) for root in PKGS)
    assert port == jax
    assert port["move"]["moved_objects"] == 10
    assert port["after_move"][0] == port["after_move"][1] == 2
    assert port["rollback"][0] is False and port["rollback"][1] == 2
    assert sorted(map(len, port["rollback"][2])) == [0, 5]
    assert port["rollback"][3] == [[], []]
    assert port["thawed"] == 6
    assert port["retire"][3][1] == 0 and port["retire"][4] == [1]


# ---------------------------------------------------------------------------
# the elastic client across a failover's epoch bump


def test_rv_watchdog_survives_a_failover_epoch_bump_mid_watch():
    from kubernetes_tpu_torch.apiserver.rest import APIServer
    from kubernetes_tpu_torch.apiserver.store import ClusterStore
    from kubernetes_tpu_torch.client.restcluster import RestClusterClient

    root = "kubernetes_tpu_torch"
    servers, urls = _spin(root, 2)
    fresh = None
    client = RestClusterClient(urls[0], partition_urls=urls,
                               watch_kinds=("Pod",))
    seen, lock = [], threading.Lock()

    def on_events(evs):
        with lock:
            seen.extend(e.obj.metadata.name for e in evs)

    def wait_seen(cond):
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            with lock:
                if cond(seen):
                    return True
            time.sleep(0.05)
        return False

    try:
        assert client.enable_topology(poll_interval=0.1)
        client.watch(on_events)
        time.sleep(0.3)
        p1_ns = next(ns for ns in (f"ns-{i}" for i in range(50))
                     if client._topology.partition_of("Pod", ns, None)
                     == 1)
        for i in range(30):
            client.create_object("Pod", _pod(root, f"hw{i}", ns=p1_ns))
        assert wait_seen(lambda s: sum(n.startswith("hw") for n in s)
                         >= 30)
        # the high-water marks against the old partition 1: the fresh
        # server's versions restart far below them
        with client._rv_lock:
            client._last_rv[("Pod", 0)] = 7
            client._last_rv[("Pod", 1)] = 10_000
        fresh = APIServer(store=ClusterStore(), partition=(1, 2)).start()
        new_topo = client._topology.evolve(urls=[urls[0], fresh.url])
        servers[0].install_topology(new_topo)
        fresh.install_topology(new_topo)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline \
                and client.topology_epoch < new_topo.epoch:
            time.sleep(0.05)
        assert client.topology_epoch == new_topo.epoch
        time.sleep(0.4)   # the handoff stream attaches
        assert client.rv_regressions == []
        with client._rv_lock:
            assert client._last_rv.get(("Pod", 0), 0) >= 7
            assert client._last_rv.get(("Pod", 1), 0) < 10_000
        client.create_object("Pod", _pod(root, "post-epoch", ns=p1_ns))
        assert wait_seen(lambda s: "post-epoch" in s)
        # the restarted partition's stream was handed off, not relisted;
        # the empty fresh store reads as deletions of the old pods
        assert client.stream_relists == {}
        assert client.handoff_fetches >= 1
        with lock:
            assert seen.count("post-epoch") == 1
    finally:
        client._stop_watches()
        client._drop_conn()
        _shutdown(servers)
        if fresh is not None:
            fresh.shutdown_server()


# ---------------------------------------------------------------------------
# the elastic drivers


def _driver_script(root):
    part = _mod(root, "apiserver.partition")
    drivers = _mod(root, "autoscaler.partitions")
    store = part.PartitionedStore(partitions=2, reshardable=True)
    for ns in ("ns-a", "ns-b", "ns-c"):
        for i in range(6):
            store.create_pod(_pod(root, f"p{i}", ns=ns))
    for i in range(4):
        store.add_node(_node(root, f"n{i}"))
    driver = drivers.InprocElasticDriver(store)

    def placement():
        return [sorted((p.namespace, p.metadata.name)
                       for p in s.list_pods()) for s in store.parts]

    out = []
    for action in ({"op": "buy"}, {"op": "split", "namespace": "ns-b"},
                   {"op": "retire", "partition": 0}):
        report = driver.apply(action)
        obs = driver.observe()
        out.append((action["op"],
                    {k: v for k, v in report.items() if k != "frozen_ms"},
                    obs["topology"].to_dict(), obs["epoch"],
                    obs["dead"], placement()))
    store.stop()
    return out


def test_inproc_driver_buy_split_and_retire_equal_the_reference():
    jax, port = (_driver_script(root) for root in PKGS)
    assert port == jax
    buy, split, retire = port
    assert buy[1]["new_partition"] == 2 and buy[3] == 3
    assert "ns-b" in split[2]["spread"]
    assert 0 in retire[2]["retired"] and not retire[5][0]


def test_rest_driver_observes_the_fleet_ledgers():
    from kubernetes_tpu_torch.apiserver.reshard import ReshardCoordinator
    from kubernetes_tpu_torch.autoscaler.partitions import (
        RestElasticDriver,
        plan_rebalance,
        PartitionGroup,
        RebalancePolicy,
    )
    from kubernetes_tpu_torch.client.restcluster import RestClusterClient

    root = "kubernetes_tpu_torch"
    servers, urls = _spin(root, 3)
    client = RestClusterClient(urls[0], partition_urls=urls)
    try:
        assert client.enable_topology(poll_interval=0)
        client.create_objects_bulk(
            "Pod", [_pod(root, f"h{i}", ns="hot") for i in range(40)]
            + [_pod(root, f"c{i}", ns=f"cold-{i}") for i in range(4)])
        driver = RestElasticDriver(ReshardCoordinator(client),
                                   federate=False)
        obs = driver.observe()
        assert obs["epoch"] == 1 and obs["dead"] == []
        assert obs["ns_writes"]["hot"] == 40
        assert sum(obs["slot_writes"].values()) == 44
        action = plan_rebalance(obs["slot_writes"], obs["ns_writes"],
                                obs["topology"], obs["dead"],
                                RebalancePolicy(), PartitionGroup())
        assert action == {"op": "split", "namespace": "hot"}
        report = driver.apply(action)
        assert report["reason"] == "split" and report["epoch"] == 2
        hot = {i for i, s in enumerate(servers)
               if s.store.list_pods("hot")}
        assert len(hot) > 1
        assert sum(len(s.store.list_pods("hot")) for s in servers) == 40
        # a dead partition: its listening socket closed, so a connect is
        # refused, and its kept-alive connections dropped
        servers[2].shutdown_server()
        servers[2].server_close()
        client._drop_conn()
        assert driver.observe()["dead"] == [2]
    finally:
        client._drop_conn()
        _shutdown(servers[:2])


# ---------------------------------------------------------------------------
# the chaos cells


@pytest.mark.parametrize("cell", ["midstorm", "rebalance"])
def test_chaos_cell_holds_every_invariant_as_the_reference(cell):
    results = {}
    for root in PKGS:
        mod = _mod(root, "harness.chaos_reshard")
        results[root] = mod.run_chaos_reshard(11, scenario=cell)
    jax, port = results[PKGS[0]], results[PKGS[1]]
    assert port["ok"], port["failure"]
    assert jax["ok"], jax["failure"]
    assert port["profile"] == jax["profile"] == cell
    # the port's cells count more: lost, relists and freeze time
    assert set(port["stats"]) >= set(jax["stats"])
    assert port["stats"]["lost"] == 0
    if cell == "midstorm":
        assert port["stats"]["migrations"] == 3
        assert port["stats"]["moved"] > 0
    else:
        assert "split" in port["stats"]["actions"]
        assert port["stats"]["hot_partitions"] > 1


def test_sigkill_cell_rolls_back_or_completes():
    from kubernetes_tpu_torch.harness.chaos_reshard import run_reshard_sigkill

    r = run_reshard_sigkill(11)
    assert r["ok"], r["failure"]
    assert r["stats"]["outcome"]
    assert r["stats"]["server_pods"] == r["stats"]["confirmed"] > 0
    assert r["stats"]["lost"] == 0
    with pytest.raises(ValueError, match="scenario"):
        _mod("kubernetes_tpu_torch",
             "harness.chaos_reshard").run_chaos_reshard(1, scenario="x")


# ---------------------------------------------------------------------------
# the WAL's synchronous append


def _log_names(d):
    with open(os.path.join(d, "wal.jsonl"), encoding="utf-8") as f:
        return [json.loads(line)["o"]["metadata"]["name"]
                for line in f if line.strip()]


def test_an_acknowledged_write_is_in_the_log_before_it_returns(tmp_path):
    from kubernetes_tpu.apiserver.wal import restore_store as jax_restore
    from kubernetes_tpu_torch.apiserver.rest import APIServer
    from kubernetes_tpu_torch.apiserver.store import ClusterStore
    from kubernetes_tpu_torch.apiserver.wal import attach_wal, restore_store
    from kubernetes_tpu_torch.client.restcluster import RestClusterClient

    root = "kubernetes_tpu_torch"
    store = ClusterStore()
    wal = attach_wal(store, str(tmp_path))
    assert not wal.async_serialize and wal._writer is None
    store.create_pod(_pod(root, "direct"))
    assert _log_names(str(tmp_path)) == ["direct"]   # no drain
    server = APIServer(store=store).start()
    client = RestClusterClient(server.url)
    try:
        client.create_object("Pod", _pod(root, "one"))
        assert _log_names(str(tmp_path))[-1] == "one"
        made = client.create_objects_bulk(
            "Pod", [_pod(root, f"bulk{i}") for i in range(50)])
        assert made == 50
        # a bulk create's events are on disk when its response arrives
        assert _log_names(str(tmp_path))[-50:] == [
            f"bulk{i}" for i in range(50)]
    finally:
        client.close()
        server.shutdown_server()
    wal.snapshot()
    assert _log_names(str(tmp_path)) == []   # compacted into the snapshot
    wal.close()
    names = sorted(p.metadata.name for p in restore_store(
        str(tmp_path)).list_pods())
    assert names == sorted(p.metadata.name for p in jax_restore(
        str(tmp_path)).list_pods()) and len(names) == 52


def test_a_sigkilled_child_restores_every_acknowledged_pod(tmp_path):
    from kubernetes_tpu.apiserver.wal import restore_store as jax_restore
    from kubernetes_tpu_torch.apiserver.wal import restore_store
    from kubernetes_tpu_torch.client.restcluster import RestClusterClient
    from kubernetes_tpu_torch.harness.chaos_reshard import (
        CREATOR_TOKEN,
        _chaos_apiserver_main,
    )

    root = "kubernetes_tpu_torch"
    ctx = mp.get_context("spawn")
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=_chaos_apiserver_main,
                       args=(child, 0, 1, str(tmp_path), False),
                       daemon=True)
    proc.start()
    try:
        url = parent.recv()
        client = RestClusterClient(url, token=CREATOR_TOKEN)
        acked = []
        for i in range(40):
            client.create_object("Pod", _pod(root, f"k{i}", ns="sk"))
            acked.append(f"k{i}")
        acked += [f"kb{i}" for i in range(60)]
        assert client.create_objects_bulk(
            "Pod", [_pod(root, f"kb{i}", ns="sk") for i in range(60)]) == 60
        client.close()
        proc.kill()   # SIGKILL: no drain, no close
        proc.join(timeout=10.0)
    finally:
        if proc.is_alive():
            proc.terminate()
    for restore in (restore_store, jax_restore):
        got = sorted(p.metadata.name
                     for p in restore(str(tmp_path)).list_pods("sk"))
        assert got == sorted(acked)


# ---------------------------------------------------------------------------
# the drain


def _stalled_bulk_create(stall_s):
    """One partition server whose store stalls ``stall_s`` inside a bulk
    create, a bulk create of 8 pods on a thread, and a coordinator: the
    create has passed the topology gate when this returns."""
    reshard = _mod("kubernetes_tpu_torch", "apiserver.reshard")
    Client = _mod("kubernetes_tpu_torch",
                  "client.restcluster").RestClusterClient
    servers, urls = _spin("kubernetes_tpu_torch", 1)
    store = servers[0].store
    real, entered = store.create_pods, threading.Event()

    def stalled(pods):
        entered.set()
        time.sleep(stall_s)
        return real(pods)

    store.create_pods = stalled
    client = Client(urls[0], partition_urls=urls, max_retries=0)
    assert client.enable_topology(poll_interval=0)
    writer = threading.Thread(target=client.create_objects_bulk, args=(
        "Pod", [_pod("kubernetes_tpu_torch", f"d{i}") for i in range(8)]))
    writer.start()
    assert entered.wait(10)
    co = reshard.ReshardCoordinator(client, evict_grace_s=0.0)
    slots = co.fetch_topology().slots_of_partition(0)
    return servers, client, writer, co, slots


def test_a_freeze_answers_after_the_writes_it_let_through():
    servers, client, writer, co, slots = _stalled_bulk_create(0.6)
    try:
        t0 = time.monotonic()
        co._freeze({0: slots}, 5.0)
        waited = time.monotonic() - t0
        # the acknowledged create is in the store the copy or the WAL
        # snapshot reads next
        assert len(servers[0].store.list_pods()) == 8
        assert waited >= 0.3
        assert set(servers[0].frozen_slots) == set(slots)
        writer.join(10)
    finally:
        client.close()
        _shutdown(servers)


def test_a_freeze_that_cannot_drain_in_its_budget_aborts_thawed():
    reshard = _mod("kubernetes_tpu_torch", "apiserver.reshard")
    servers, client, writer, co, slots = _stalled_bulk_create(1.5)
    try:
        with pytest.raises(reshard.ReshardError, match="did not drain"):
            co._freeze({0: slots}, 0.3)
        assert servers[0].frozen_slots == {}
        writer.join(10)
        assert len(servers[0].store.list_pods()) == 8
    finally:
        client.close()
        _shutdown(servers)
