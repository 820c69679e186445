"""The partitioned control plane of the port against the JAX package's:

- routing: ``partition_for``, ``partitions_for``, ``slot_for`` and the
  ``PartitionTopology`` give the JAX package's answers on seeded names;
- the differential guard: at ``partitions=1`` with synchronous dispatch
  the port's router gives a bare port ``ClusterStore``'s event sequence,
  versions and ``kind_seq``; at 1 and 3 partitions it gives the JAX
  router's event sequence, versions included, on the same script;
- the composite cursor, a resume and a torn resume; per-partition WAL
  segments restored with versions that never go back; a stalled
  watcher of one partition that does not delay another;
- the bind-time ledger: the same verdicts as the JAX ledger on a seeded
  bind script, and released capacity after a delete;
- the in-process slot moves (the JAX ``tests/test_reshard.py``'s
  ``TestTopology`` and ``TestReshardableStore``): the same moved counts,
  versions and silent watches as the JAX store on the same script;
- replica sharding with and without pod hashing, the mini scale cell
  and the conflict cell (their invariants: races between replicas give
  no placements to compare);
- the partition-aware REST client over real partition servers: routing
  equal to the server-side truth and to the JAX routing function, fan-in
  lists, split bulk binds, one watch stream a (kind, partition), the
  informer factory over the merged streams and the topology check.

Tolerance: exact equality."""

import json
import random
import threading
import time

import pytest

from kubernetes_tpu.apiserver import partition as jax_partition
from kubernetes_tpu.apiserver.store import ClusterStore as JaxStore
from kubernetes_tpu.testing import MakeNode as JaxMakeNode
from kubernetes_tpu.testing import MakePod as JaxMakePod
from kubernetes_tpu_torch.apiserver import partition
from kubernetes_tpu_torch.apiserver.partition import (
    CapacityConflictError,
    CompositeCursor,
    PartitionedStore,
    PartitionTopology,
    SliceFrozenError,
    partition_for,
)
from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.testing import MakeNode, MakePod

PKGS = {
    "jax": (jax_partition, JaxStore, JaxMakeNode, JaxMakePod),
    "port": (partition, ClusterStore, MakeNode, MakePod),
}


def _node(name, cpu="4", memory="8Gi", pods="110", pkg="port"):
    return PKGS[pkg][2]().name(name).capacity(
        {"cpu": cpu, "memory": memory, "pods": pods}).obj()


def _pod(name, ns="default", uid=None, cpu="100m", memory="50Mi",
         pkg="port"):
    p = PKGS[pkg][3]().name(name).uid(uid or f"u-{ns}-{name}").req(
        {"cpu": cpu, "memory": memory}).obj()
    p.metadata.namespace = ns
    return p


def _watch(store, pkg, sink):
    """Every event to ``sink`` (the JAX store's watch takes one event a
    call, the port's a batch)."""
    if pkg == "jax":
        return store.watch(sink)
    return store.watch(lambda evs: [sink(e) for e in evs])


def _names(rng, n):
    return [f"{rng.choice(['ns', 'tenant', 'team'])}-{rng.randrange(10**6)}"
            for _ in range(n)]


# ---------------------------------------------------------------------------
# routing


@pytest.mark.parametrize("partitions", [1, 2, 3, 4, 7])
def test_routing_equals_the_reference(partitions):
    rng = random.Random(partitions)
    names = _names(rng, 400)
    for kind in ("Pod", "Node", "Service", "ConfigMap", "Lease"):
        for name in names:
            assert partition_for(kind, name, name, partitions) == \
                jax_partition.partition_for(kind, name, name, partitions)
            assert partition.slot_for(kind, name, name) == \
                jax_partition.slot_for(kind, name, name)
            spread = frozenset(names[:20])
            assert partition.slot_for(kind, name, f"{name}-x",
                                      spread=spread) == \
                jax_partition.slot_for(kind, name, f"{name}-x",
                                       spread=spread)
        assert partition.partitions_for(kind, partitions) == \
            jax_partition.partitions_for(kind, partitions)
        assert partition.partitions_for(kind, partitions, names[0]) == \
            jax_partition.partitions_for(kind, partitions, names[0])
    if partitions > 1:
        # the sharded kinds do spread
        assert {partition_for("Pod", ns, None, partitions)
                for ns in names} == set(range(partitions))


def test_topology_equals_the_reference():
    """The JAX ``TestTopology`` cases, each answer held against the
    reference's topology."""
    urls = ["http://a", "http://b", "http://c"]
    topo = PartitionTopology.default(3, urls=urls)
    ref = jax_partition.PartitionTopology.default(3, urls=urls)
    assert topo.to_dict() == ref.to_dict()
    back = PartitionTopology.from_dict(json.loads(json.dumps(topo.to_dict())))
    assert back.owner == topo.owner and back.urls == topo.urls
    owner = list(topo.owner)
    owner[0] = 1
    nxt, ref_nxt = topo.evolve(owner=owner), ref.evolve(owner=owner)
    assert nxt.epoch == topo.epoch + 1 and topo.owner[0] == 0
    assert nxt.to_dict() == ref_nxt.to_dict()
    spread = topo.evolve(spread={"tenant-a"})
    ref_spread = ref.evolve(spread={"tenant-a"})
    for kind in ("Pod", "Node", "ConfigMap", "Lease"):
        for ns in ("tenant-a", "tenant-b", None):
            assert spread.partitions_for(kind, ns) == \
                ref_spread.partitions_for(kind, ns)
            for i in range(20):
                assert spread.partition_of(kind, ns, f"p{i}") == \
                    ref_spread.partition_of(kind, ns, f"p{i}")
    assert len(topo.partitions_for("Pod", "tenant-a")) == 1
    assert spread.partitions_for("Pod", "tenant-a") == \
        sorted(set(spread.owner))
    assert topo.partition_of("ConfigMap", "ns", "x") == 0
    assert topo.partitions_for("Lease") == [0]
    assert repr(topo) == repr(ref)


# ---------------------------------------------------------------------------
# the differential guard


def _mutation_script(store, pkg):
    """Pods and nodes, bulk verbs, generic objects, a status write, and
    deletes. Returns the event log (type, kind, name, rv)."""
    from importlib import import_module

    types = import_module(("kubernetes_tpu" if pkg == "jax"
                           else "kubernetes_tpu_torch") + ".api.types")
    log = []
    _watch(store, pkg, lambda e: log.append(
        (e.type, e.kind, e.obj.metadata.name,
         int(e.obj.metadata.resource_version or 0))))
    store.add_node(_node("n1", pkg=pkg))
    store.add_node(_node("n2", pkg=pkg))
    store.create_pod(_pod("a1", "nsa", pkg=pkg))
    store.create_pods([_pod(f"b{i}", "nsb", pkg=pkg) for i in range(4)])
    store.bind("nsa", "a1", "u-nsa-a1", "n1")
    store.bind_many([("nsb", f"b{i}", f"u-nsb-b{i}", "n2")
                     for i in range(4)])
    store.set_pod_phase("nsa", "a1", "Running", pod_ip="10.0.0.1")
    store.add_service(types.Service(metadata=types.ObjectMeta(
        name="s1", namespace="nsa")))
    store.create_object("ConfigMap", types.ConfigMap(
        metadata=types.ObjectMeta(name="cm1", namespace="nsa")))
    store.create_objects_bulk("Node", [_node(f"m{i}", pkg=pkg)
                                       for i in range(5)])
    store.update_object("Node", _node("m0", cpu="8", pkg=pkg))
    store.delete_pod("nsb", "b0")
    store.delete_pods([("nsb", "b1"), ("nsa", "nope")])
    store.delete_node("n2")
    store.delete_object("Node", "", "m3")
    return log


def test_one_partition_equals_a_bare_store():
    plain = ClusterStore()
    sharded = PartitionedStore(1)
    log_plain = _mutation_script(plain, "port")
    log_sharded = _mutation_script(sharded, "port")
    assert log_plain == log_sharded
    for kind in ("Pod", "Node", "Service", "ConfigMap"):
        assert plain.kind_seq(kind) == sharded.kind_seq(kind), kind
    assert plain.current_rv() == sharded.current_rv()
    assert sorted(p.metadata.resource_version for p in plain.list_pods()) \
        == sorted(p.metadata.resource_version for p in sharded.list_pods())
    assert plain.count_bound() == sharded.count_bound()


@pytest.mark.parametrize("partitions", [1, 3])
def test_router_events_equal_the_reference(partitions):
    ref = jax_partition.PartitionedStore(partitions)
    port = PartitionedStore(partitions)
    log_ref = _mutation_script(ref, "jax")
    log_port = _mutation_script(port, "port")
    assert log_port == log_ref
    for kind in ("Pod", "Node", "Service", "ConfigMap"):
        assert port.kind_seq(kind) == ref.kind_seq(kind), kind
    assert [p.current_rv() for p in port.parts] == \
        [p.current_rv() for p in ref.parts]
    assert port.cursor().encode() == ref.cursor().encode()
    for i in range(partitions):
        assert sorted(p.full_name() for p in port.parts[i].list_pods()) == \
            sorted(p.full_name() for p in ref.parts[i].list_pods())
    if partitions > 1:
        # each object keeps its own order; versions stay unique
        by_obj = {}
        for e in log_port:
            by_obj.setdefault((e[1], e[2]), []).append(e[0])
        assert by_obj[("Pod", "a1")] == ["ADDED", "MODIFIED", "MODIFIED"]
        rvs = [e[3] for e in log_port]
        assert len(set(rvs)) == len(rvs)


def test_generic_surface_routes_consistently():
    ps = PartitionedStore(4)
    ps.create_object("Pod", _pod("g1", "nsg"))
    assert ps.get_pod("nsg", "g1") is not None
    assert ps.get_object("Pod", "nsg", "g1") is not None
    assert len(ps.list_objects("Pod")) == 1
    objs, rv = ps.list_objects_with_rv("Pod")
    assert len(objs) == 1 and rv >= 1
    assert ps.mutate_object("Pod", "nsg", "g1",
                            lambda p: setattr(p.status, "phase", "Running"))
    assert ps.get_pod("nsg", "g1").status.phase == "Running"
    assert ps.delete_object("Pod", "nsg", "g1")
    assert ps.get_pod("nsg", "g1") is None


# ---------------------------------------------------------------------------
# WAL segments, the cursor, watch isolation


def test_wal_segments_restore_and_rv_never_regresses(tmp_path):
    d = str(tmp_path)
    ps = PartitionedStore(2)
    ps.attach_wal(d)
    for i in range(6):
        ps.create_pod(_pod(f"w{i}", f"wns{i % 2}"))
    ps.bind("wns0", "w0", "u-wns0-w0", "n1")
    high = ps.current_rv()
    ps.stop()
    ps2 = PartitionedStore(2)
    ps2.attach_wal(d, restore=True)
    assert sorted(p.name for p in ps2.list_pods()) == \
        [f"w{i}" for i in range(6)]
    assert ps2.count_bound() == 1
    ps2.create_pod(_pod("fresh", "wns0"))
    assert int(ps2.get_pod("wns0", "fresh").metadata.resource_version) > high
    ps2.stop()


def test_cursor_encode_parse_covers():
    for rvs in ((5, 9, 2), (7,), (0, 0)):
        c, ref = CompositeCursor(rvs), jax_partition.CompositeCursor(rvs)
        assert c.encode() == ref.encode()
        assert CompositeCursor.parse(c.encode()) == c
    c = CompositeCursor((5, 9, 2))
    assert c.covers(CompositeCursor((5, 8, 2)))
    assert not c.covers(CompositeCursor((6, 8, 2)))
    assert not c.covers(CompositeCursor((5, 8)))


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_resume_and_torn_resume(pkg):
    mod = PKGS[pkg][0]
    ps = mod.PartitionedStore(3)
    ps.enable_resume()
    for i in range(6):
        ps.create_pod(_pod(f"pre{i}", f"ns{i % 3}", pkg=pkg))
    objs, cursor = ps.list_with_cursor("Pod")
    assert len(objs) == 6
    for i in range(6):
        ps.create_pod(_pod(f"post{i}", f"ns{i % 3}", pkg=pkg))
    got = []
    handle = ps.watch_from_cursor(
        cursor, lambda rv, e: got.append(e.obj.metadata.name))
    assert sorted(got) == sorted(f"post{i}" for i in range(6))
    ps.create_pod(_pod("live0", "ns0", pkg=pkg))
    assert "live0" in got
    handle.stop()

    from importlib import import_module

    wc = import_module(mod.__name__.rsplit(".", 1)[0] + ".watchcache")
    ps = mod.PartitionedStore(2)
    ps.enable_resume()
    ns_by_part = {}
    i = 0
    while len(ns_by_part) < 2:
        ns_by_part.setdefault(
            mod.partition_for("Pod", f"t{i}", None, 2), f"t{i}")
        i += 1
    ps.create_pod(_pod("seed0", ns_by_part[0], pkg=pkg))
    ps.create_pod(_pod("seed1", ns_by_part[1], pkg=pkg))
    _objs, cursor = ps.list_with_cursor("Pod")
    for i in range(40):
        ps.create_pod(_pod(f"churn{i}", ns_by_part[0], pkg=pkg))
    ps._watch_caches[0].compact(keep_last=2)
    with pytest.raises(wc.TooOldResourceVersion):
        ps.watch_from_cursor(cursor, lambda rv, e: None)
    ps.create_pod(_pod("after1", ns_by_part[1], pkg=pkg))
    got = []
    h = ps._watch_caches[1].watch_from(
        cursor.component(1), lambda rv, e: got.append(e.obj.metadata.name))
    assert got == ["after1"]
    h.stop()


def test_per_partition_rv_monotonic_under_concurrent_writers():
    ps = PartitionedStore(3)
    logs = [[] for _ in range(3)]
    for i, part in enumerate(ps.parts):
        part.watch(lambda evs, log=logs[i]: log.extend(
            int(e.obj.metadata.resource_version or 0) for e in evs))
    errors = []

    def writer(ns):
        try:
            for i in range(30):
                ps.create_pod(_pod(f"p{i}", ns))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(f"w{i}",))
               for i in range(9)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    for log in logs:
        assert log == sorted(log)
    rvs = [rv for log in logs for rv in log]
    assert len(rvs) == 9 * 30 and len(set(rvs)) == len(rvs)


def test_stalled_watcher_on_one_partition_does_not_delay_another():
    ps = PartitionedStore(2, async_dispatch=True)
    ns_by_part = {}
    i = 0
    while len(ns_by_part) < 2:
        ns_by_part.setdefault(partition_for("Pod", f"s{i}", None, 2),
                              f"s{i}")
        i += 1
    stall = threading.Event()
    delivered = []

    def sink(events):
        for e in events:
            ns = e.obj.metadata.namespace
            delivered.append((ns, time.monotonic()))
            if partition_for("Pod", ns, None, 2) == 0:
                stall.wait(5.0)

    ps.watch(sink)
    t0 = time.monotonic()
    ps.create_pod(_pod("slow", ns_by_part[0]))
    time.sleep(0.05)
    ps.create_pod(_pod("fast", ns_by_part[1]))
    deadline = time.monotonic() + 2.0
    while time.monotonic() < deadline and \
            not any(ns == ns_by_part[1] for ns, _ in delivered):
        time.sleep(0.01)
    fast = [ts for ns, ts in delivered if ns == ns_by_part[1]]
    assert fast and fast[0] - t0 < 1.0
    stall.set()
    assert ps.drain()
    ps.stop()


# ---------------------------------------------------------------------------
# the bind-time ledger


def _ledger_script(pkg, seed):
    """A seeded run of binds, bulk binds and deletes over tight nodes;
    returns each call's verdict (None or the error's type name)."""
    mod = PKGS[pkg][0]
    rng = random.Random(seed)
    ps = mod.PartitionedStore(2, capacity_guard=True)
    for n in range(4):
        ps.add_node(_node(f"t{n}", cpu="1", pkg=pkg))
    out = []
    live = []
    for i in range(60):
        ns = f"ns{rng.randrange(3)}"
        cpu = f"{rng.choice([200, 300, 500, 700])}m"
        ps.create_pod(_pod(f"p{i}", ns, cpu=cpu, pkg=pkg))
        node = f"t{rng.randrange(4)}"
        if rng.random() < 0.5:
            try:
                ps.bind(ns, f"p{i}", f"u-{ns}-p{i}", node)
                out.append(None)
                live.append((ns, f"p{i}"))
            except Exception as e:  # noqa: BLE001
                out.append(type(e).__name__)
        else:
            errs = ps.bind_many([(ns, f"p{i}", f"u-{ns}-p{i}", node),
                                 (ns, f"p{i}", f"u-{ns}-p{i}",
                                  f"t{rng.randrange(4)}")])
            out.append([type(e).__name__ if e else None for e in errs])
            if errs[0] is None or errs[1] is None:
                live.append((ns, f"p{i}"))
        if live and rng.random() < 0.3:
            ns, name = live.pop(rng.randrange(len(live)))
            ps.delete_pod(ns, name)
            out.append(("deleted", name))
    out.append(sorted((p.full_name(), p.spec.node_name)
                      for p in ps.list_pods() if p.spec.node_name))
    return out


@pytest.mark.parametrize("seed", [3, 11])
def test_ledger_verdicts_equal_the_reference(seed):
    got = _ledger_script("port", seed)
    assert got == _ledger_script("jax", seed)
    flat = [x for v in got[:-1] for x in (v if isinstance(v, list) else [v])]
    assert "CapacityConflictError" in flat


def test_ledger_refuses_oversubscription_and_releases():
    ps = PartitionedStore(2, capacity_guard=True)
    ps.add_node(_node("tight", cpu="1"))
    ps.create_pod(_pod("w1", cpu="600m"))
    ps.create_pod(_pod("w2", cpu="600m"))
    ps.bind("default", "w1", "u-default-w1", "tight")
    with pytest.raises(CapacityConflictError):
        ps.bind("default", "w2", "u-default-w2", "tight")
    ps.create_pod(_pod("w3", cpu="300m"))
    ps.bind("default", "w3", "u-default-w3", "tight")
    ps.delete_pod("default", "w1")
    ps.bind("default", "w2", "u-default-w2", "tight")   # fits again


def test_ledger_holds_under_racing_binders():
    """Sixteen threads bind pods of 300m onto four nodes of one cpu
    over three partitions, with a short switch interval: the ledger
    must never let a node's bound requests pass its allocatable (a lost
    update in the reserve would), and every bind either lands or is
    refused."""
    import sys

    ps = PartitionedStore(3, capacity_guard=True)
    for n in range(4):
        ps.add_node(_node(f"t{n}", cpu="1"))
    for w in range(16):
        ps.create_pods([_pod(f"p{i}", f"ns{w}", cpu="300m")
                        for i in range(6)])
    verdicts = []

    def binder(w):
        rng = random.Random(w)
        for i in range(6):
            try:
                ps.bind(f"ns{w}", f"p{i}", f"u-ns{w}-p{i}",
                        f"t{rng.randrange(4)}")
                verdicts.append("bound")
            except CapacityConflictError:
                verdicts.append("refused")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=binder, args=(w,))
                   for w in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    per_node = {}
    for p in ps.list_pods():
        if p.spec.node_name:
            per_node[p.spec.node_name] = per_node.get(p.spec.node_name,
                                                      0) + 300
    assert len(verdicts) == 96
    assert verdicts.count("bound") == sum(per_node.values()) // 300 == 12
    assert all(v <= 1000 for v in per_node.values())


# ---------------------------------------------------------------------------
# in-process slot moves


def _fill(store, pkg, namespaces=("ns-a", "ns-b", "ns-c"), per_ns=6):
    for ns in namespaces:
        for i in range(per_ns):
            store.create_pod(_pod(f"p{i}", ns=ns, pkg=pkg))
    for i in range(4):
        store.add_node(_node(f"n{i}", pkg=pkg))


def _reshard_script(pkg, tmp_dir):
    """The JAX ``TestReshardableStore`` cases in one script: move,
    silent watches, split, add and move, retire, failover from the WAL,
    stats. Returns what each step shows."""
    mod = PKGS[pkg][0]
    out = {}
    store = mod.PartitionedStore(partitions=2, reshardable=True,
                                 evict_grace_s=0.0)
    store.attach_wal(tmp_dir)
    _fill(store, pkg)
    events = []
    _watch(store, pkg, events.append)
    topo = store.topology
    slot = topo.slot_of("Pod", "ns-a", None)
    src, dest = topo.owner[slot], 1 - topo.owner[slot]
    before = {p.metadata.name: p.metadata.resource_version
              for p in store.list_pods("ns-a")}
    report = store.migrate_slots({slot: dest})
    out["move"] = {k: report[k] for k in ("moved_objects", "epoch",
                                          "frozen_slots", "rv_barrier")}
    out["moved_rvs"] = sorted(
        (p.metadata.name, p.metadata.resource_version)
        for p in store.parts[dest].list_pods("ns-a"))
    assert dict(out["moved_rvs"]) == before
    out["src_left"] = len(store.parts[src].list_pods("ns-a"))
    store.create_pod(_pod("after", ns="ns-b", pkg=pkg))
    out["events"] = [(e.type, e.obj.metadata.name) for e in events]
    report = store.restart_partition(dest)
    out["failover"] = {k: report[k] for k in ("restored_objects", "epoch")}
    out["after_failover"] = sorted(
        (p.metadata.name, p.metadata.resource_version)
        for p in store.parts[dest].list_pods("ns-a"))
    idx = store.add_partition()
    slot_c = store.topology.slot_of("Pod", "ns-c", None)
    out["move2"] = store.migrate_slots({slot_c: idx})["moved_objects"]
    store.create_pod(_pod("fresh", ns="ns-c", pkg=pkg))
    out["fresh_on_new"] = store.parts[idx].get_pod("ns-c", "fresh") \
        is not None
    for i in range(24):
        store.create_pod(_pod(f"hot{i}", ns="hot", pkg=pkg))
    out["split"] = store.spread_namespace("hot")["moved_objects"]
    out["hot_holders"] = [len(p.list_pods("hot")) for p in store.parts]
    out["retire"] = store.retire_partition(2)["moved_objects"]
    out["per_part"] = [len(p.list_pods()) for p in store.parts]
    stats = store.reshard_stats()
    out["stats"] = {k: stats[k] for k in ("epoch", "partitions",
                                          "slot_writes", "ns_writes",
                                          "migrations")}
    out["all"] = sorted((p.full_name(), p.metadata.resource_version)
                        for p in store.list_pods())
    out["watch_names"] = [n for t, n in
                          ((e.type, e.obj.metadata.name) for e in events)]
    store.stop()
    return out


def test_slot_moves_equal_the_reference(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    got = _reshard_script("port", str(tmp_path / "port"))
    want = _reshard_script("jax", str(tmp_path / "jax"))
    assert got == want
    assert got["src_left"] == 0 and got["events"] == [("ADDED", "after")]
    assert got["after_failover"] == got["moved_rvs"]
    assert sum(1 for n in got["hot_holders"] if n) > 1
    assert got["per_part"][2] == 0


def test_freeze_blocks_a_writer_then_expires():
    store = PartitionedStore(partitions=2, reshardable=True)
    slot = store.topology.slot_of("Pod", "frozen-ns", None)
    with store._freeze_cond:
        store._frozen[slot] = time.monotonic() + 5.0
    landed = threading.Event()

    def writer():
        store.create_pod(_pod("w", ns="frozen-ns"))
        landed.set()

    threading.Thread(target=writer, daemon=True).start()
    assert not landed.wait(0.15)
    with store._freeze_cond:
        store._frozen.pop(slot, None)
        store._freeze_cond.notify_all()
    assert landed.wait(2.0)
    with store._freeze_cond:
        store._frozen[slot] = time.monotonic() + 0.2

    def extend():
        time.sleep(0.05)
        with store._freeze_cond:
            store._frozen[slot] = time.monotonic() + 30.0

    threading.Thread(target=extend, daemon=True).start()
    with pytest.raises(SliceFrozenError) as exc:
        store._wait_unfrozen(slot)
    assert exc.value.retry_after > 0
    with store._freeze_cond:
        store._frozen[slot] = time.monotonic() - 0.01
    store._wait_unfrozen(slot)
    assert slot not in store._frozen


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_adopt_never_regresses_a_newer_write(pkg):
    store = PKGS[pkg][1]()
    store.create_pod(_pod("x", ns="a", pkg=pkg))
    store.set_pod_phase("a", "x", "Running")
    live = store.get_pod("a", "x")
    stale = _pod("x", ns="a", pkg=pkg)
    stale.metadata.resource_version = "1"
    assert store.adopt_objects("Pod", [stale]) == 0
    assert store.get_pod("a", "x").metadata.resource_version == \
        live.metadata.resource_version
    newer = _pod("x", ns="a", pkg=pkg)
    newer.spec.node_name = "n1"
    newer.metadata.resource_version = str(
        int(live.metadata.resource_version) + 5)
    assert store.adopt_objects("Pod", [newer]) == 1
    assert store.current_rv() == int(live.metadata.resource_version) + 5
    assert [p.name for p in store.evict_objects("Pod", [("a", "x")])] == ["x"]
    if pkg == "port":
        assert store.count_bound() == 0


# ---------------------------------------------------------------------------
# replicas over the partitioned store


@pytest.mark.parametrize("shard_pods,shard_nodes", [
    (True, False), (True, True), (False, False)])
def test_install_replica_sharding_equals_the_reference(shard_pods,
                                                       shard_nodes):
    from kubernetes_tpu.scheduler.replicas import (
        ReplicaSpec as JaxSpec,
        install_replica_sharding as jax_install,
    )
    from kubernetes_tpu.scheduler.scheduler import Scheduler as JaxScheduler
    from kubernetes_tpu_torch.scheduler.replicas import (
        ReplicaSpec,
        install_replica_sharding,
    )
    from kubernetes_tpu_torch.scheduler.scheduler import Scheduler

    for i in range(2):
        ref = jax_install(JaxScheduler.create(JaxStore()), JaxSpec(
            index=i, count=2, shard_pods=shard_pods,
            shard_nodes=shard_nodes))
        got = install_replica_sharding(Scheduler.create(ClusterStore()),
                                       ReplicaSpec(
            index=i, count=2, shard_pods=shard_pods,
            shard_nodes=shard_nodes))
        assert (got.pod_shard is None) == (ref.pod_shard is None)
        assert (got.node_shard is None) == (ref.node_shard is None)
        assert got.commit_capacity_guard == ref.commit_capacity_guard
        assert got.replica_name == ref.replica_name
        for k in range(40):
            pod = _pod(f"p{k}", uid=f"uid-{k}")
            jpod = _pod(f"p{k}", uid=f"uid-{k}", pkg="jax")
            if got.pod_shard is not None:
                assert got.pod_shard(pod) == ref.pod_shard(jpod)
            if got.node_shard is not None:
                assert got.node_shard(f"n{k}") == ref.node_shard(f"n{k}")


def test_replica_commit_lock_only_over_a_bare_store():
    """Replicas sharing nodes hold the commit lock over any client with
    no bind-time ledger, and leave it to the ledger where there is one."""
    from kubernetes_tpu_torch.scheduler.replicas import SchedulerReplicaSet

    bare = ClusterStore()
    rs = SchedulerReplicaSet(lambda i: bare, count=2, shard_nodes=False)
    assert all(s.commit_lock is not None for s in rs.replicas)
    unguarded = PartitionedStore(2)
    rs = SchedulerReplicaSet(lambda i: unguarded, count=2,
                             shard_nodes=False)
    assert all(s.commit_lock is not None for s in rs.replicas)
    assert rs.replicas[0].commit_lock is rs.replicas[1].commit_lock
    ps = PartitionedStore(2, capacity_guard=True)
    rs = SchedulerReplicaSet(lambda i: ps, count=2, shard_nodes=False)
    assert all(s.commit_lock is None for s in rs.replicas)
    assert all(s.commit_capacity_guard for s in rs.replicas)


@pytest.mark.parametrize("capacity_guard", [False, True])
def test_replicas_sharing_nodes_never_overfill_one(capacity_guard):
    """Two replicas over one shared pool of ten two-CPU nodes and forty
    half-CPU pods, exactly the room there is: with the ledger or, where
    the store has none, the commit lock, every pod binds once and no
    node passes its allocatable."""
    from kubernetes_tpu_torch.scheduler.replicas import SchedulerReplicaSet

    ps = PartitionedStore(2, capacity_guard=capacity_guard)
    for i in range(10):
        ps.add_node(_node(f"n{i}", cpu="2", memory="64Gi"))
    rs = SchedulerReplicaSet(lambda i: ps, count=2, shard_nodes=False,
                             use_batch=True, max_batch=64, device="cpu")
    rs.start()
    rs.run()
    try:
        ps.create_pods([_pod(f"p{k}", ns=f"ns-{k % 4}", cpu="500m")
                        for k in range(40)])
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and ps.count_bound() < 40:
            time.sleep(0.01)
        rs.flush()
    finally:
        rs.stop()
        ps.stop()
    per_node = {}
    for p in ps.list_pods():
        if p.spec.node_name:
            per_node[p.spec.node_name] = per_node.get(p.spec.node_name,
                                                      0) + 1
    assert sum(per_node.values()) == 40
    assert max(per_node.values()) <= 4, per_node
    assert all(n > 0 for n in rs.bound_counts())


def test_mini_scale_cell():
    """Two partitions (a dispatch thread each), two replicas (pod-hash
    queues, node pools), 120 hollow nodes, 400 pods: every pod bound
    once, no node over, the partitions balanced, every partition and
    replica registry federated."""
    from kubernetes_tpu_torch.harness.scale import run_scale_arm_inproc

    arm = run_scale_arm_inproc(nodes=120, pods=400, partitions=2,
                               replicas=2, use_batch=False, node_cpu=16,
                               wait_timeout=120.0)
    assert arm["lost_pods"] == 0 and arm["double_binds"] == 0
    assert arm["bound"] == 400
    assert arm["partition_balance"] > 0.3
    assert sum(arm["replica_pools"]) == 120
    fed = [i for i in arm["federation_instances"]
           if i.startswith(("partition-", "scheduler-"))]
    assert len(fed) >= 4, arm["federation_instances"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_conflict_cell_resolves_every_collision(pkg):
    """Replicas racing on every pod over tight nodes: conflicts happen
    in both packages, every one resolves, no pod is lost or bound twice
    and no node is over. At the port's scale-row size (40 nodes / 152
    pods, as tight as the cell's default 10 / 38, where the two replicas
    now and then never race)."""
    from importlib import import_module

    from kubernetes_tpu_torch.harness.scale import (
        CONFLICT_NODES,
        CONFLICT_PODS,
    )

    root = "kubernetes_tpu" if pkg == "jax" else "kubernetes_tpu_torch"
    scale = import_module(f"{root}.harness.scale")
    fm = import_module(f"{root}.metrics.fabric_metrics").fabric_metrics()
    before = sum(v for _, _, v in fm.stale_binds_rejected_total.collect())
    cell = scale.run_conflict_cell(nodes=CONFLICT_NODES, pods=CONFLICT_PODS)
    after = sum(v for _, _, v in fm.stale_binds_rejected_total.collect())
    assert cell["ok"], cell
    assert cell["bound"] == CONFLICT_PODS
    assert cell["conflicts_total"] > 0
    assert cell["lost_pods"] == 0 and cell["double_binds"] == 0
    assert after > before
    assert set(cell["conflicts"]) <= {"capacity", "bind_conflict",
                                      "replica_conflict"}


def test_bind_conflict_counted_and_unwound():
    """A bind the ledger refuses unwinds (unreserve, forget, requeue)
    and counts under ``bind_conflict``; a pod a sibling bound first
    counts under ``replica_conflict``."""
    from kubernetes_tpu_torch.scheduler.scheduler import Scheduler

    ps = PartitionedStore(2, capacity_guard=True)
    ps.add_node(_node("tight", cpu="1"))
    sched = Scheduler.create(ps)
    sched._note_bind_conflict(CapacityConflictError(
        "pod a/b: capacity conflict on node 'tight'"))
    sched._note_bind_conflict(ValueError(
        "pod a/b is already assigned to node 'x'"))
    sched._note_bind_conflict(KeyError("pod a/b not found"))
    assert sched.stale_binds_rejected == {"bind_conflict": 1,
                                          "replica_conflict": 1}


# ---------------------------------------------------------------------------
# the partition-aware REST client


def _spin_up(parts):
    from kubernetes_tpu_torch.apiserver.rest import APIServer

    servers = [APIServer(store=ClusterStore(), partition=(i, parts)).start()
               for i in range(parts)]
    return servers, [s.url for s in servers]


def test_client_routing_equals_server_truth_and_the_reference():
    from kubernetes_tpu_torch.client.restcluster import RestClusterClient

    servers, urls = _spin_up(2)
    client = RestClusterClient(urls[0], partition_urls=urls,
                               watch_kinds=("Pod",))
    try:
        pods = [_pod(f"r{i}", f"rns{i % 5}") for i in range(20)]
        assert client.create_objects_bulk("Pod", pods) == 20
        assert client.create_objects_bulk(
            "Node", [_node(f"rn{i}") for i in range(8)]) == 8
        for i, server in enumerate(servers):
            for p in server.store.list_pods():
                assert jax_partition.partition_for(
                    "Pod", p.namespace, None, 2) == i
            for n in server.store.list_nodes():
                assert jax_partition.partition_for(
                    "Node", None, n.name, 2) == i
        assert len(client.list_pods()) == 20
        assert len(client.list_nodes()) == 8
        assert len(client.list_pods("rns1")) == 4
        assert client.get_pod("rns1", "r1") is not None
        assert client.get_node("rn3") is not None
        errs = client.bind_many([(p.namespace, p.metadata.name,
                                  p.metadata.uid, "rn0") for p in pods])
        assert errs == [None] * 20
        assert all(p.spec.node_name == "rn0" for p in client.list_pods())
        again = client.bind_many([("rns0", "r0", "u-rns0-r0", "rn1")])
        assert isinstance(again[0], ValueError)
        assert client.write_pod_statuses([
            {"namespace": p.namespace, "name": p.metadata.name,
             "status": {"phase": "Running"}} for p in pods]) == [None] * 20
        assert client.set_pod_phase("rns2", "r2", "Succeeded")
        assert client.get_pod("rns2", "r2").status.phase == "Succeeded"
        client.delete_pods([("rns3", "r3"), ("rns4", "r4")])
        assert len(client.list_pods()) == 18
        assert client.try_acquire_or_renew("node-rn0", "rn0", 0.0, 40.0)
        assert servers[0].store.lease_holder("node-rn0") == "rn0"
        assert client.rv_regressions == []
    finally:
        client.close()
        for s in servers:
            s.shutdown_server()


def test_watch_opens_a_stream_a_kind_and_partition():
    from kubernetes_tpu_torch.apiserver.store import ADDED
    from kubernetes_tpu_torch.client.restcluster import RestClusterClient

    servers, urls = _spin_up(2)
    client = RestClusterClient(urls[0], partition_urls=urls,
                               watch_kinds=("Pod", "Node", "Service"))
    got = []
    try:
        first = [_pod(f"pre{i}", f"wns{i}") for i in range(4)]
        client.create_objects_bulk("Pod", first)
        initial = client.list_for_watch()
        assert isinstance(initial["Pod"][1], CompositeCursor)
        assert len(initial["Pod"][0]) == 4
        client.watch(got.extend, resume=initial)
        # Pod and Node on both partitions, Service on partition 0 only
        assert len(client._watch_threads) == 5
        client.create_objects_bulk("Pod", [_pod(f"w{i}", f"wns{i}")
                                           for i in range(8)])
        client.create_objects_bulk("Node", [_node(f"wn{i}")
                                            for i in range(4)])
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and \
                sum(e.type == ADDED for e in got) < 12:
            time.sleep(0.05)
        names = sorted(e.obj.metadata.name for e in got if e.type == ADDED)
        # what the lists held is not delivered again
        assert names == sorted([f"w{i}" for i in range(8)]
                               + [f"wn{i}" for i in range(4)])
    finally:
        client.close()
        for s in servers:
            s.shutdown_server()


def test_informer_factory_merges_partition_streams():
    from kubernetes_tpu_torch.client.informers import SharedInformerFactory
    from kubernetes_tpu_torch.client.restcluster import RestClusterClient

    servers, urls = _spin_up(2)
    client = RestClusterClient(urls[0], partition_urls=urls,
                               watch_kinds=("Pod", "Node"))
    factory = SharedInformerFactory(client)
    pods = factory.lister_for("Pod")
    services = factory.lister_for("Service")   # the generic list verb
    try:
        client.create_objects_bulk(
            "Pod", [_pod(f"inf{i}", f"ins{i}") for i in range(6)])
        factory.start()
        assert factory.wait_for_cache_sync()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and len(pods.list()) < 6:
            time.sleep(0.05)
        assert len(pods.list()) == 6
        assert services.list() == []
        client.create_objects_bulk(
            "Pod", [_pod(f"live{i}", f"ins{i}") for i in range(4)])
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and len(pods.list()) < 10:
            time.sleep(0.05)
        assert len(pods.list()) == 10
    finally:
        factory.stop()
        client.close()
        for s in servers:
            s.shutdown_server()


def test_partition_topology_check_catches_misroute():
    from kubernetes_tpu_torch.client.restcluster import RestClusterClient

    servers, urls = _spin_up(2)
    try:
        client = RestClusterClient(urls[0], partition_urls=urls)
        for i in range(2):
            code, topo = client._request(
                "GET", "/api/v1/partitiontopology", partition=i)
            assert code == 200 and topo == {"partition": i, "partitions": 2}
        client.check_partition_topology()
        client.close()
        bad = RestClusterClient(urls[1], partition_urls=[urls[1], urls[0]])
        with pytest.raises(RuntimeError, match="misconfigured"):
            bad.check_partition_topology()
        bad.close()
    finally:
        for s in servers:
            s.shutdown_server()
