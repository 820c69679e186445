"""The port's federation tier against the JAX package's, on the CPU: the
home map, the capacity ledger, the federation scheduler (the numpy
oracle and the scan: ``serial=True`` and ``serial=False``), the
rebalancer's driver, the failover client and the verdict surface, each
case run through both packages on the same inputs; placements compared
as (namespace, cluster) pairs. The in-process cells (cluster loss,
spillover, the degradation differential) are timed runs: the port's are
held to the verdicts the reference's tests hold. Tolerance: exact
equality everywhere."""

import pytest

from kubernetes_tpu import federation as jax_fed
from kubernetes_tpu.api.types import Node as JaxNode, Pod as JaxPod
from kubernetes_tpu.apiserver.store import ClusterStore as JaxStore
from kubernetes_tpu.federation.rebalancer import (
    _FederationDriver as JaxDriver,
)
from kubernetes_tpu.harness import federation as jax_harness
from kubernetes_tpu_torch import federation as port_fed
from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.federation.rebalancer import _FederationDriver
from kubernetes_tpu_torch.harness import federation as port_harness

SIDES = {
    "jax": dict(fed=jax_fed, Node=JaxNode, Pod=JaxPod, Store=JaxStore,
                Driver=JaxDriver, harness=jax_harness, kw={}),
    "port": dict(fed=port_fed, Node=Node, Pod=Pod, Store=ClusterStore,
                 Driver=_FederationDriver, harness=port_harness,
                 kw={"device": "cpu"}),
}


class Side:
    """One package's federation objects, built from the same plain
    values."""

    def __init__(self, name):
        self.name = name
        self.__dict__.update(SIDES[name])

    def node(self, name, cpu_milli, memory="68719476736"):
        return self.Node.from_dict({
            "metadata": {"name": name,
                         "labels": {"kubernetes.io/hostname": name}},
            "status": {"capacity": {"cpu": f"{cpu_milli}m",
                                    "memory": memory, "pods": "110"}}})

    def pod(self, name, ns="default", milli=500, gang=""):
        labels = {self.fed.GANG_NAME_LABEL: gang} if gang else {}
        pod = self.Pod.from_dict({
            "metadata": {"name": name, "namespace": ns, "labels": labels},
            "spec": {"containers": [
                {"name": "c", "image": "registry/fake:1",
                 "resources": {"requests": {"cpu": f"{milli}m",
                                            "memory": "1048576"}}}]}})
        pod.metadata.uid = f"uid-{ns}-{name}"
        return pod

    def ledger(self, capacities):
        """cluster id -> total milli-cpu, observed as one node each."""
        ledger = self.fed.CapacityLedger()
        for cid, milli in capacities.items():
            ledger.register(cid)
            ledger.refresh_from(cid, [self.node(f"c{cid}-node-0", milli)], [])
        return ledger

    def scheduler(self, ledger, serial=True, home_of=None):
        return self.fed.FederationScheduler(
            ledger, policy=self.fed.FederationPolicy(serial=serial),
            home_of=home_of, **self.kw)


def both(case):
    """``case(side)`` through the port and the JAX package."""
    return case(Side("port")), case(Side("jax"))


def pairs(placements):
    return [(pl.unit.namespace, pl.cluster) for pl in placements]


# ----------------------------------------------------------------------
# the home map
def test_home_map_hash_pin_override_spread():
    def case(s):
        hm = s.fed.HomeMap([0, 1, 2], pin={"tenant-a": 2})
        out = [hm.home_of(f"ns-{i}") for i in range(40)]
        out.append(hm.home_of("tenant-a"))
        hm.overrides["tenant-a"] = 1
        out.append(hm.home_of("tenant-a"))
        hm.spread.add("tenant-a")
        out.append(hm.home_of("tenant-a"))
        return out

    got, want = both(case)
    assert got == want
    assert set(got[:40]) <= {0, 1, 2} and got[40:] == [2, 1, None]


# ----------------------------------------------------------------------
# the capacity ledger
def _cap(cap):
    return tuple(sorted(vars(cap).items()))


def test_refresh_computes_capacity_and_usage():
    def case(s):
        ledger = s.fed.CapacityLedger()
        bound = s.pod("p-0", milli=1000)
        bound.spec.node_name = "c0-node-0"
        cap = ledger.refresh_from(0, [s.node("c0-node-0", 16000)],
                                  [bound, s.pod("p-1", milli=500)])
        return _cap(cap), ledger.remaining(0)

    got, want = both(case)
    assert got == want
    assert dict(got[0])["used_milli"] == 1500 and got[1][0] == 14500


def test_admissions_reserve_until_a_refresh_observes_them():
    def case(s):
        ledger = s.ledger({0: 16000})
        routed = s.pod("p-0", milli=4000)
        ledger.note_admitted(0, [routed])
        before = (ledger.remaining(0), ledger.utilization(0))
        ledger.refresh_from(0, [s.node("c0-node-0", 16000)], [routed])
        return before, _cap(ledger.capacity(0)), ledger.remaining(0)

    got, want = both(case)
    assert got == want
    assert got[0][0][0] == 12000 and got[0][1] == 0.25
    assert dict(got[1])["admitted_pods"] == 0 and got[2][0] == 12000


def test_refresh_never_drops_an_unobserved_reservation():
    def case(s):
        ledger = s.ledger({0: 16000})
        ledger.note_admitted(0, [s.pod("p-0", milli=4000)])
        ledger.refresh_from(0, [s.node("c0-node-0", 16000)], [])
        return ledger.remaining(0), _cap(ledger.capacity(0))

    got, want = both(case)
    assert got == want
    assert got[0][0] == 12000 and dict(got[1])["admitted_pods"] == 1


def test_re_reserving_a_pod_replaces_not_double_counts():
    def case(s):
        ledger = s.ledger({0: 16000})
        pod = s.pod("p-0", milli=4000)
        ledger.note_admitted(0, [pod])
        ledger.note_admitted(0, [pod])
        return ledger.remaining(0), _cap(ledger.capacity(0))

    got, want = both(case)
    assert got == want and got[0][0] == 12000


def test_write_counts_are_cumulative_per_cluster_and_tenant():
    def case(s):
        ledger = s.ledger({0: 16000, 1: 16000})
        ledger.note_admitted(0, [s.pod("p-0", ns="a"), s.pod("p-1", ns="a")])
        ledger.note_admitted(1, [s.pod("p-2", ns="b")])
        return ledger.write_counts()

    got, want = both(case)
    assert got == want == ({0: 2.0, 1: 1.0}, {"a": 2.0, "b": 1.0})


def test_liveness_flags():
    def case(s):
        ledger = s.ledger({0: 1000, 1: 1000})
        ledger.mark_dead(0)
        out = [ledger.live_clusters(), ledger.dead_clusters(),
               ledger.alive(0)]
        ledger.mark_alive(0)
        return out + [ledger.live_clusters()]

    got, want = both(case)
    assert got == want == [[1], [0], False, [0, 1]]


# ----------------------------------------------------------------------
# clusters as what-if columns
def test_gangs_fold_into_one_unit():
    def case(s):
        units = s.fed.group_units([s.pod("g-0", gang="fg-0", milli=700),
                                   s.pod("s-0", milli=500),
                                   s.pod("g-1", gang="fg-0", milli=700)])
        return [(u.gang, u.milli, u.mem, u.namespace,
                 [p.metadata.name for p in u.pods]) for u in units]

    got, want = both(case)
    assert got == want
    assert got[0] == ("fg-0", 1400, 2097152, "default", ["g-0", "g-1"])


def _home_wins(s, serial):
    ledger = s.ledger({0: 16000, 1: 16000})
    sched = s.scheduler(ledger, serial, home_of=lambda ns: 1)
    return [(pl.cluster, pl.spilled) for pl in sched.place([s.pod("p-0")])]


def _saturated_home_spills(s, serial):
    ledger = s.ledger({0: 16000, 1: 16000})
    ledger.note_admitted(0, [s.pod("fat", milli=14000)])
    sched = s.scheduler(ledger, serial, home_of=lambda ns: 0)
    return [(pl.cluster, pl.spilled) for pl in sched.place([s.pod("p-0")])]


def _dead_never_chosen(s, serial):
    ledger = s.ledger({0: 16000, 1: 16000})
    ledger.mark_dead(0)
    sched = s.scheduler(ledger, serial, home_of=lambda ns: 0)
    return pairs(sched.place([s.pod("p-0")]))


def _gang_atomic(s, serial):
    ledger = s.ledger({0: 16000, 1: 16000})
    pods = [s.pod(f"g-{i}", gang="fg-0", milli=800) for i in range(4)]
    return [(pl.cluster, len(pl.unit.pods))
            for pl in s.scheduler(ledger, serial).place(pods)]


def _no_live_cluster(s, serial):
    ledger = s.ledger({0: 16000})
    ledger.mark_dead(0)
    sched = s.scheduler(ledger, serial, home_of=lambda ns: 0)
    return pairs(sched.place([s.pod("p-0")])), sched.unplaced_units


def _mixed_homes(s, serial):
    ledger = s.ledger({0: 16000, 1: 16000, 2: 16000})
    ledger.note_admitted(1, [s.pod("fat", milli=14000)])
    sched = s.scheduler(ledger, serial,
                        home_of=lambda ns: {"a": 0, "b": 1, "c": 2}.get(ns))
    pods = [s.pod("p-0", ns="a"), s.pod("p-1", ns="b"),
            s.pod("g-0", ns="c", gang="fg-0"),
            s.pod("g-1", ns="c", gang="fg-0")]
    return pairs(sched.place(pods)), sched.solves


def _overflow(s, serial):
    """More units than fit anywhere: the home fills, then the siblings by
    tier, then the rest stay unplaced."""
    ledger = s.ledger({0: 4000, 1: 6000, 2: 3000})
    ledger.note_admitted(2, [s.pod("fat", milli=2700)])
    sched = s.scheduler(ledger, serial,
                        home_of=lambda ns: {"a": 0, "b": 1}.get(ns))
    pods = [s.pod(f"p-{i}", ns="ab"[i % 2], milli=900) for i in range(16)]
    pods += [s.pod(f"g-{i}", ns="c", gang=f"fg-{i // 3}", milli=1100)
             for i in range(6)]
    return pairs(sched.place(pods)), sched.placed_units, sched.unplaced_units


SCHEDULER_CASES = {
    "home-wins": (_home_wins, [(1, False)]),
    "saturated-home-spills": (_saturated_home_spills, [(1, True)]),
    "dead-never-chosen": (_dead_never_chosen, [("default", 1)]),
    "gang-atomic": (_gang_atomic, None),
    "no-live-cluster": (_no_live_cluster, ([("default", None)], 1)),
    "mixed-homes": (_mixed_homes, None),
    "overflow": (_overflow, None),
}


@pytest.mark.parametrize("serial", [True, False], ids=["oracle", "scan"])
@pytest.mark.parametrize("name", sorted(SCHEDULER_CASES))
def test_scheduler_places_like_the_reference(name, serial):
    case, expected = SCHEDULER_CASES[name]
    got, want = both(lambda s: case(s, serial))
    assert got == want
    if expected is not None:
        assert got == expected
    if name == "gang-atomic":
        assert got[0][0] in (0, 1) and got[0][1] == 4


@pytest.mark.parametrize("name", sorted(SCHEDULER_CASES))
def test_oracle_and_scan_place_alike(name):
    case, _ = SCHEDULER_CASES[name]
    side = Side("port")
    assert case(side, True) == case(side, False)


def test_down_layer_raises_federation_unavailable():
    for s in (Side("port"), Side("jax")):
        sched = s.scheduler(s.ledger({0: 16000}))
        sched.set_down(True)
        with pytest.raises(s.fed.FederationUnavailable):
            sched.place([s.pod("p-0")])


def test_default_device_is_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_fed.FederationScheduler(port_fed.CapacityLedger())


def test_cluster_capacity_past_int32_fails_as_the_reference():
    """A cluster of 40 nodes of 64 Gi: its memory in KiB passes 2^31.
    Both packages refuse to encode it, with the same error."""
    def case(s):
        ledger = s.fed.CapacityLedger()
        ledger.refresh_from(0, [s.node(f"c0-node-{i}", 16000, "64Gi")
                                for i in range(40)], [])
        out = []
        for serial in (True, False):
            try:
                out.append(pairs(s.scheduler(ledger, serial).place(
                    [s.pod("p-0")])))
            except Exception as e:  # noqa: BLE001 — compared below
                out.append((type(e).__name__, str(e)))
        return out

    got, want = both(case)
    assert got == want
    assert got[0][0] == "OverflowError"


# ----------------------------------------------------------------------
# the rebalancer's driver
class _StubClient:
    def __init__(self, s):
        self.ledger = s.fed.CapacityLedger()
        self.home_map = s.fed.HomeMap([0, 1, 2], pin={"fed-0": 0})
        self.failed = []
        for cid in (0, 1, 2):
            self.ledger.register(cid)

    def failover_cluster(self, cid):
        self.failed.append(cid)
        return 7


def _observe(obs):
    topo = obs["topology"]
    return (obs["epoch"], obs["slot_writes"], obs["ns_writes"], obs["dead"],
            topo.partitions, sorted(topo.retired), topo.owner,
            [topo.slots_of_partition(p) for p in range(topo.partitions)])


def test_driver_speaks_the_contract_and_fails_over_once():
    def case(s):
        client = _StubClient(s)
        driver = s.Driver(client)
        out = [_observe(driver.observe())]
        client.ledger.mark_dead(1)
        out.append(_observe(driver.observe()))
        out.append(driver.apply({"op": "failover", "partition": 1}))
        out.append(_observe(driver.observe()))
        return out, client.failed

    got, want = both(case)
    assert got == want
    assert got[0][1][3] == [1] and got[0][3][3] == [] and got[1] == [1]


def test_driver_split_move_buy_retire():
    def case(s):
        client = _StubClient(s)
        driver = s.Driver(client)
        client.ledger.note_admitted(0, [s.pod("p-0", ns="fed-0"),
                                        s.pod("p-1", ns="fed-0")])
        out = [driver.apply({"op": "move", "assignments": {0: 2}}),
               client.home_map.home_of("fed-0"),
               driver.apply({"op": "split", "namespace": "fed-0"}),
               client.home_map.home_of("fed-0"),
               driver.apply({"op": "buy"}),
               driver.apply({"op": "retire", "partition": 2})]
        return out

    got, want = both(case)
    assert got == want
    assert got[:2] == [{"moved": {"fed-0": 2}}, 2] and got[3] is None


def test_rebalancer_ticks_like_the_reference():
    """The same write pattern through both packages' rebalancers, a tick
    at a time: the same actions."""
    def case(s):
        client = _StubClient(s)
        reb = s.fed.ClusterRebalancer(client)
        reb.group.cooldown_s = 0.0
        out = []
        for tick in range(8):
            ns = "fed-0" if tick < 5 else f"t{tick}"
            client.ledger.note_admitted(
                0, [s.pod(f"p{tick}-{i}", ns=ns) for i in range(40)])
            client.ledger.note_admitted(1, [s.pod(f"q{tick}", ns="x")])
            if tick == 6:
                client.ledger.mark_dead(2)
            done = reb.tick()
            out.append(None if done is None
                       else (done["action"], done["report"]))
        return out

    got, want = both(case)
    assert got == want
    assert any(a and a[0]["op"] == "failover" for a in got)


# ----------------------------------------------------------------------
# the failover client over in-process stores
def _federation(s):
    stores = {cid: s.Store() for cid in (0, 1)}
    for cid, store in stores.items():
        store.add_node(s.Node.from_dict({
            "metadata": {"name": f"c{cid}-node-0"},
            "status": {"capacity": {"cpu": "16", "memory": "68719476736",
                                    "pods": "110"}}}))
    ledger = s.fed.CapacityLedger()
    home_map = s.fed.HomeMap([0, 1], pin={"a": 0, "b": 1})
    sched = s.fed.FederationScheduler(ledger, home_of=home_map.home_of,
                                      **s.kw)
    client = s.fed.FederatedClusterClient(stores, sched, ledger,
                                          home_map=home_map)
    for cid, store in stores.items():
        ledger.refresh_from(cid, store.list_nodes(), store.list_pods())
    return stores, client


def _names(store):
    return sorted(p.metadata.name for p in store.list_pods())


def test_failover_replaces_dead_cell_pods_by_name():
    def case(s):
        stores, client = _federation(s)
        client.create_pods([s.pod(f"a-{i}", ns="a") for i in range(4)]
                           + [s.pod("b-0", ns="b")])
        before = [_names(stores[0]), _names(stores[1])]
        replaced = client.failover_cluster(0)
        return (before, replaced, _names(stores[1]), client.route_of("a", "a-0"),
                client.counters())

    got, want = both(case)
    assert got == want
    assert got[1] == 4 and got[3] == 1 and got[4]["failovers"] == 1


def test_gang_continuity_pins_later_chunks():
    def case(s):
        _, client = _federation(s)
        client.create_pods([s.pod("g-0", ns="a", gang="fg-0")])
        client.create_pods([s.pod("g-1", ns="a", gang="fg-0")])
        return client.route_of("a", "g-0"), client.route_of("a", "g-1")

    got, want = both(case)
    assert got == want and got[0] == got[1]


def test_scheduler_failure_degrades_to_home_routing():
    def case(s):
        _, client = _federation(s)
        client.scheduler.set_down(True)
        client.create_pods([s.pod("a-0", ns="a"), s.pod("b-0", ns="b")])
        return (client.route_of("a", "a-0"), client.route_of("b", "b-0"),
                client.counters())

    got, want = both(case)
    assert got == want
    assert got[:2] == (0, 1) and got[2]["fallback_placements"] == 2


def test_spill_routes_and_watch_fans_in():
    """A burst past home's room spills to the sibling; one watch sees the
    creates of both cells, and stops on both."""
    def case(s):
        stores, client = _federation(s)
        seen = []
        def on_events(events):
            seen.extend((e.type, e.obj.metadata.name) for e in events)

        # the reference's watch takes a per-event callback first
        handle = client.watch(on_events) if s.name == "port" else \
            client.watch(lambda e: on_events([e]), batch_fn=on_events)
        client.create_pods([s.pod(f"a-{i}", ns="a", milli=3000)
                            for i in range(8)])
        handle.stop()
        client.create_pods([s.pod("late", ns="b")])
        return (_names(stores[0]), _names(stores[1]), sorted(seen),
                client.counters(), sorted(p.metadata.name
                                          for p in client.list_pods()))

    got, want = both(case)
    assert got == want
    assert got[3]["spilled"] > 0 and ("ADDED", "late") not in got[2]


# ----------------------------------------------------------------------
# the verdict surface
def test_scenario_catalog():
    assert port_harness.FEDERATION_SCENARIOS \
        == jax_harness.FEDERATION_SCENARIOS
    assert set(port_harness.FEDERATION_SCENARIOS) == {
        "spill", "loss-early", "loss-mid", "loss-late", "spill-loss"}
    with pytest.raises(ValueError, match="unknown federation"):
        port_harness.run_federation_mini_cell(scenario="bogus", device="cpu")


def test_verdict_surface_flips_on_every_invariant():
    base = {"scenario": "spill-loss", "lost_pods": 0, "injected": 10,
            "ever_bound": 10, "send_errors": [], "gang_splits": 0,
            "survivor_relists": 0, "per_cluster_slo_ok": True,
            "recovery_ratio": 1.0, "victim": 1, "slo_verdicts_ok": True,
            "spilled": 3, "failovers": 1}
    assert port_harness._federation_ok(dict(base)) == (True, "")
    for key, bad in [("lost_pods", 2), ("ever_bound", 9),
                     ("send_errors", ["boom"]), ("gang_splits", 1),
                     ("survivor_relists", 4), ("per_cluster_slo_ok", False),
                     ("recovery_ratio", 0.5), ("slo_verdicts_ok", False),
                     ("spilled", 0), ("failovers", 0),
                     ("scenario", "loss-mid"), ("victim", None)]:
        res = dict(base)
        res[key] = bad
        got = port_harness._federation_ok(res)
        assert got == jax_harness._federation_ok(res), key
        if key not in ("scenario", "victim"):
            assert not got[0] and got[1], key


@pytest.mark.parametrize("scenario", ["spill", "loss-mid", "spill-loss"])
def test_fleet_sizing_and_trace_match_the_reference(scenario):
    got_t = port_harness.build_federation_trace(18, 240, 400.0, namespaces=6)
    want_t = jax_harness.build_federation_trace(18, 240, 400.0, namespaces=6)
    assert [e.to_dict() for e in got_t.events] \
        == [e.to_dict() for e in want_t.events]
    assert port_harness._fleet_sizing(got_t, 3, 16, scenario) \
        == jax_harness._fleet_sizing(want_t, 3, 16, scenario)
    assert port_harness._cluster_nodes(1, 3, 16) \
        == jax_harness._cluster_nodes(1, 3, 16)


# ----------------------------------------------------------------------
# the in-process cells (timed runs: verdicts, not binds)
@pytest.fixture(scope="module")
def loss_cell():
    return port_harness.run_federation_mini_cell(
        pods=120, scenario="loss-mid", seed=18, device="cpu")


@pytest.fixture(scope="module")
def spill_cell():
    return port_harness.run_federation_mini_cell(
        pods=120, scenario="spill", seed=18, device="cpu",
        policy=port_fed.FederationPolicy(serial=False))


def test_loss_cell_zero_lost_and_failed_over(loss_cell):
    assert loss_cell["lost"] == 0
    assert loss_cell["ever_bound"] == loss_cell["injected"] == 120
    assert loss_cell["victim"] is not None and loss_cell["failovers"] >= 1
    assert "failover" in loss_cell["rebalancer_actions"]
    assert loss_cell["recovery_ratio"] >= 0.8


def test_loss_cell_gangs_never_split(loss_cell):
    assert loss_cell["gang_splits"] == 0 and loss_cell["gangs_partial"] == 0
    assert loss_cell["gangs_total"] == 3


def test_spill_cell_lands_overflow_remotely(spill_cell):
    assert spill_cell["victim"] is None and spill_cell["spilled"] > 0
    assert spill_cell["lost"] == 0
    assert spill_cell["ever_bound"] == spill_cell["injected"] == 120
    assert all(v["bound"] > 0 for v in spill_cell["per_cluster"].values())
    assert spill_cell["per_cluster_slo_ok"]
    assert spill_cell["fed_solves"] > 0


def test_degradation_differential_binds_the_identical_set():
    res = port_harness.run_degradation_differential(pods=120, qps=400,
                                                    seed=18, device="cpu")
    assert res["identical"], (len(res["bound_on"]), len(res["bound_down"]))
    assert res["on"]["lost"] == 0 and res["down"]["lost"] == 0
    assert res["down"]["fallbacks"] > 0 and res["on"]["fallbacks"] == 0
    assert len(res["bound_on"]) == 120


# ----------------------------------------------------------------------
# the rebalancing planner
class _Topology:
    """Slots owned round-robin by partitions, some retired, some
    namespaces already spread."""

    def __init__(self, rng, partitions, slots):
        self.partitions = partitions
        self.owner = [int(rng.integers(partitions)) for _ in range(slots)]
        self.retired = {p for p in range(partitions) if rng.random() < 0.15}
        self.spread = {f"ns{i}" for i in range(4) if rng.random() < 0.3}

    def slots_of_partition(self, p):
        return [s for s, o in enumerate(self.owner) if o == p]


# seeds 0-12 plan every action: failover, split, move, buy, retire, none
@pytest.mark.parametrize("seed", range(13))
def test_plan_rebalance_decides_like_the_reference(seed):
    import numpy as np
    from kubernetes_tpu.autoscaler import partitions as jax_partitions
    from kubernetes_tpu_torch.autoscaler import partitions

    rng = np.random.default_rng(seed)
    topo = _Topology(rng, int(rng.integers(2, 6)), int(rng.integers(4, 24)))
    scale = float(rng.choice([1.0, 30.0, 600.0]))
    slot_rates = {s: float(rng.exponential(scale)) * (rng.random() < 0.8)
                  for s in range(len(topo.owner))}
    ns_rates = {f"ns{i}": float(rng.exponential(scale))
                for i in range(int(rng.integers(0, 5)))}
    dead = [int(rng.integers(topo.partitions))] if seed % 5 == 0 else []
    got = partitions.plan_rebalance(
        slot_rates, ns_rates, topo, dead, partitions.RebalancePolicy(),
        partitions.PartitionGroup(max_partitions=6))
    want = jax_partitions.plan_rebalance(
        slot_rates, ns_rates, topo, dead, jax_partitions.RebalancePolicy(),
        jax_partitions.PartitionGroup(max_partitions=6))
    assert got == want
