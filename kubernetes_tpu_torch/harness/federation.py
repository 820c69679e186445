"""Federation cells: cluster loss and saturation spillover, in process.

K independent clusters (each a store, a gang scheduler and a batch
scheduler on the device) behind the federation layer, under an open-loop
trace, judged by the cluster-granularity invariants:

- cluster loss: a cell is stopped mid-storm and marked dead; the
  ``ClusterRebalancer`` observes the death and fails it over, and every
  pod routed to it is created again (same names) on the survivors; zero
  lost across the fleet, the orphans bound again within
  ``RECOVERY_BUDGET_S``;
- saturation spillover: one cluster's capacity pinned far below its
  tenants' demand, so the overflow lands remotely;
- gangs: a gang is one placement unit, and at the end each gang's
  members live on one cluster;
- degradation: with the federation scheduler down every create still
  routes (to its home) and every cell keeps binding;
  ``run_degradation_differential`` holds the layer up and the layer down
  to identical bound sets on one cluster.

``run_federation_mini_cell`` runs one scenario; the device (the card
unless "cpu") carries every cell's batch solves and, with
``FederationPolicy(serial=False)``, the federation's decisions on the
scan. The reference package's spawned REST storm waits for the port's
REST fabric.
"""

from __future__ import annotations

import gc
import math
import random
import time
from dataclasses import replace
from typing import Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.types import Node
from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.config.feature_gates import FeatureGates
from kubernetes_tpu_torch.device import resolve_device
from kubernetes_tpu_torch.federation import (
    CapacityLedger,
    ClusterRebalancer,
    FederatedClusterClient,
    FederationPolicy,
    FederationScheduler,
    HomeMap,
)
from kubernetes_tpu_torch.harness.perf import attach_slo_baseline
from kubernetes_tpu_torch.harness.workloads import node_template
from kubernetes_tpu_torch.observability.tracer import get_tracer
from kubernetes_tpu_torch.scheduler.scheduler import (
    Scheduler,
    SchedulerConfiguration,
)
from kubernetes_tpu_torch.sidecar import attach_batch_scheduler
from kubernetes_tpu_torch.workloads.replay import ReplayEngine
from kubernetes_tpu_torch.workloads.trace import (
    Trace,
    events_to_pods,
    generate_trace,
)

FEDERATION_SCENARIOS = ("spill", "loss-early", "loss-mid", "loss-late",
                        "spill-loss")

FEDERATION_QPS = 300.0
RECOVERY_BUDGET_S = 30.0
P99_PER_CLUSTER_BUDGET_MS = 2500.0
RECOVERY_RATIO_FLOOR = 0.8

# where in the injection window the loss lands, by scenario
_KILL_AT = {"loss-early": 0.25, "loss-mid": 0.5, "loss-late": 0.75,
            "spill-loss": 0.5}


def build_federation_trace(seed: int, pods: int,
                           qps: float = FEDERATION_QPS,
                           namespaces: int = 12,
                           gang_every: int = 10,
                           gang_size: int = 4) -> Trace:
    """Open-loop arrivals spread round-robin over ``namespaces`` tenants
    (the namespace is the federation's affinity key), with every
    ``gang_every``-th run of ``gang_size`` consecutive arrivals folded
    into one gang of one namespace. No lifetimes: zero lost is every
    arrival bound."""
    trace = generate_trace(
        seed, pods, pods / qps, family="federation", name_prefix="fed-",
        cpu_alpha=1.8, cpu_lo=100, cpu_hi=500, lifetime_modes=None,
        burst_factor=1.0, burst_period_s=0.0)
    spread = [f"fed-{i}" for i in range(namespaces)]
    events = [replace(e, namespace=spread[i % len(spread)])
              for i, e in enumerate(trace.events)]
    g = 0
    for i in range(0, len(events) - gang_size + 1, gang_size):
        if (i // gang_size) % gang_every == gang_every - 1:
            gang = f"fg-{g}"
            g += 1
            ns = events[i].namespace
            for j in range(i, i + gang_size):
                events[j] = replace(events[j], gang=gang,
                                    gang_size=gang_size, namespace=ns)
    trace.events[:] = events
    return trace


def _cluster_nodes(cid: int, count: int, node_cpu: int) -> List[dict]:
    """A cluster's node dicts, named ``c{cid}-node-{i}``: a bind's node
    name tells its cluster."""
    out = []
    for i in range(count):
        d = node_template(i, cpu=str(node_cpu), memory="64Gi")
        name = f"c{cid}-node-{i}"
        d["metadata"]["name"] = name
        d["metadata"]["labels"]["kubernetes.io/hostname"] = name
        out.append(d)
    return out


def _fleet_sizing(trace: Trace, clusters: int, node_cpu: int,
                  scenario: str) -> Dict[int, Tuple[int, int]]:
    """(node count, node cpu cores) a cluster. Loss: the survivors alone
    hold the whole trace (sized over K - 1). Spill: cluster 0's capacity
    is about 45% of its home tenants' demand (1/K of the total), the
    siblings carry the slack."""
    demand_milli = sum(e.cpu_milli for e in trace.events)
    lossy = scenario in _KILL_AT
    carriers = max(clusters - 1, 1) if lossy else clusters
    per = max(
        2,
        math.ceil(demand_milli * 1.4 / carriers / (node_cpu * 1000)),
        math.ceil(len(trace.events) * 1.25 / carriers / 110),
    )
    sizing = {cid: (per, node_cpu) for cid in range(clusters)}
    if scenario.startswith("spill") and clusters > 1:
        home_milli = demand_milli / clusters
        count0 = max(1, math.ceil(len(trace.events) / clusters * 0.6 / 110))
        cpu0 = max(1, round(home_milli * 0.45 / count0 / 1000))
        sizing[0] = (count0, cpu0)
    return sizing


def _gang_splits(name_cluster: Dict[str, int], trace: Trace) -> int:
    """Gangs whose members ended on more than one cluster."""
    gangs: Dict[str, set] = {}
    for e in trace.events:
        if e.gang and e.name in name_cluster:
            gangs.setdefault(e.gang, set()).add(name_cluster[e.name])
    return sum(1 for members in gangs.values() if len(members) > 1)


def _per_cluster_latency(engine, clusters: int) -> Dict[str, dict]:
    """Bound pods and p99 arrival -> bind a cluster, from the engine's
    bind records (node ``c{k}-node-*`` -> cluster k)."""
    buckets: Dict[int, List[float]] = {k: [] for k in range(clusters)}
    with engine._lock:
        bind = dict(engine._bind)
        arrival = dict(engine._arrival)
    for name, (t_rel, node) in bind.items():
        if not node.startswith("c"):
            continue
        try:
            cid = int(node.split("-", 1)[0][1:])
        except ValueError:
            continue
        if cid in buckets and name in arrival:
            buckets[cid].append(max(0.0, t_rel - arrival[name]))
    out: Dict[str, dict] = {}
    for cid, lats in buckets.items():
        if not lats:
            out[f"c{cid}"] = {"bound": 0, "p99_ms": 0.0}
            continue
        lats.sort()
        p99 = lats[min(len(lats) - 1, int(0.99 * len(lats)))]
        out[f"c{cid}"] = {"bound": len(lats),
                          "p99_ms": round(p99 * 1000.0, 1)}
    return out


def _federation_ok(res: dict) -> Tuple[bool, str]:
    """A federation run's verdict: (every invariant held, the names of
    those that failed)."""
    checks = {
        "lost_pods": res["lost_pods"] == 0,
        "all_bound": res["ever_bound"] >= res["injected"] > 0,
        "send_errors": not res["send_errors"],
        "gangs_atomic": res["gang_splits"] == 0,
        "relist_confinement": res["survivor_relists"] == 0,
        "per_cluster_slo": res["per_cluster_slo_ok"],
        "recovery": (res["recovery_ratio"] >= RECOVERY_RATIO_FLOOR
                     if res["victim"] is not None else True),
        "slo": res["slo_verdicts_ok"] is not False,
    }
    if res["scenario"].startswith("spill"):
        checks["spilled"] = res["spilled"] > 0
    if res["victim"] is not None:
        checks["failed_over"] = res["failovers"] >= 1
    bad = [k for k, ok in checks.items() if not ok]
    return not bad, " ".join(bad)


def _inproc_cluster(cid: int, sizing: Tuple[int, int], max_batch: int,
                    samples, device) -> dict:
    """One cell: a store, a scheduler with the gang scheduling provider
    and a batch scheduler on ``device``, warmed on ``samples``."""
    store = ClusterStore()
    for d in _cluster_nodes(cid, *sizing):
        store.add_node(Node.from_dict(d))
    sched = Scheduler(store, config=SchedulerConfiguration(
        provider="GangSchedulingProvider"),
        feature_gates=FeatureGates({"TPUBatchScheduler": True}))
    bs = attach_batch_scheduler(sched, max_batch=max_batch, device=device)
    attach_slo_baseline(sched)
    sched.start()
    if samples:
        bs.warmup(samples)
    return {"store": store, "sched": sched, "bs": bs}


def _pump_cells(cells: Dict[int, dict], engine, ledger, deadline: float,
                on_tick: Optional[Callable] = None,
                settle_s: float = 1.0) -> None:
    """Round-robin the live cells' batch schedulers until quiet, with a
    ledger refresh every 0.2 s and ``on_tick`` (the chaos hook) each
    round."""
    quiet_since = None
    last_refresh = 0.0
    while time.monotonic() < deadline:
        if on_tick is not None:
            on_tick()
        now = time.monotonic()
        if now - last_refresh >= 0.2:
            last_refresh = now
            for cid, cell in cells.items():
                if ledger.alive(cid):
                    ledger.refresh_from(cid, cell["store"].list_nodes(),
                                        cell["store"].list_pods())
        progressed = False
        busy = not engine.injection_done.is_set()
        for cid, cell in cells.items():
            if not ledger.alive(cid):
                continue
            cell["sched"].queue.flush_backoff_completed()
            progressed |= bool(cell["bs"].run_batch(pop_timeout=0.002))
            busy |= cell["sched"].queue.pending_active_count() > 0
        now = time.monotonic()
        if progressed or busy:
            quiet_since = None
        elif quiet_since is None:
            quiet_since = now
        elif now - quiet_since >= settle_s:
            return
        time.sleep(0.002)
    raise TimeoutError("federation mini-cell did not quiesce")


def run_federation_mini_cell(
    clusters: int = 3,
    pods: int = 240,
    qps: float = 400.0,
    seed: int = 18,
    *,
    scenario: str = "loss-mid",
    node_cpu: int = 16,
    max_batch: int = 64,
    wait_timeout: float = 120.0,
    policy: Optional[FederationPolicy] = None,
    device=None,
    record_decisions: bool = False,
    progress: Optional[Callable[[str], None]] = None,
) -> dict:
    """K in-process clusters under the open loop. Loss is "stop the
    cell's scheduler, mark its ledger dead, let the rebalancer fail it
    over". ``policy``: the federation scheduler's (the reference's
    default: the numpy oracle). ``record_decisions`` returns each
    federation solve's encoded inputs and assignments. Returns the
    verdict surface."""
    if scenario not in FEDERATION_SCENARIOS:
        raise ValueError(f"unknown federation scenario {scenario!r}")
    dev = resolve_device(device)
    get_tracer().clear()
    rng = random.Random(seed)
    namespaces = 6
    trace = build_federation_trace(seed, pods, qps, namespaces=namespaces)
    sizing = _fleet_sizing(trace, clusters, node_cpu, scenario)
    samples = events_to_pods(trace.events[:64])
    cells: Dict[int, dict] = {}
    engine = None
    try:
        for cid in range(clusters):
            cells[cid] = _inproc_cluster(cid, sizing[cid], max_batch,
                                         samples, dev)
        ledger = CapacityLedger()
        home_map = HomeMap(list(range(clusters)), pin={
            f"fed-{i}": i % clusters for i in range(namespaces)})
        fed_sched = FederationScheduler(ledger, policy=policy,
                                        home_of=home_map.home_of,
                                        device=dev)
        if record_decisions:
            fed_sched.decisions = []
        fed_client = FederatedClusterClient(
            {cid: cell["store"] for cid, cell in cells.items()},
            fed_sched, ledger, home_map=home_map)
        for cid, cell in cells.items():
            ledger.refresh_from(cid, cell["store"].list_nodes(),
                                cell["store"].list_pods())
        rebalancer = ClusterRebalancer(fed_client, interval_s=0.1)
        victim: Optional[int] = None
        killed = [False]
        t_kill_rel = [0.0]
        orphans_unbound: List[str] = []
        engine = ReplayEngine(fed_client, trace, time_scale=1.0,
                              expire=False, progress=progress)
        t_start = time.monotonic()
        kill_at = _KILL_AT.get(scenario)
        if kill_at is not None:
            victim = (rng.randrange(1, clusters)
                      if scenario == "spill-loss" and clusters > 1
                      else rng.randrange(clusters))

        def on_tick() -> None:
            rebalancer.tick()
            if kill_at is None or killed[0]:
                return
            if time.monotonic() - t_start < kill_at * trace.duration_s \
                    and not engine.injection_done.is_set():
                return
            killed[0] = True
            with fed_client._lock:
                orphans = [name for (ns, name), cid
                           in fed_client._route.items() if cid == victim]
            with engine._lock:
                bound_now = set(engine._bind)
            orphans_unbound[:] = [n for n in orphans if n not in bound_now]
            t_kill_rel[0] = time.monotonic() - t_start
            cells[victim]["sched"].stop()
            ledger.mark_dead(victim)
            if progress:
                progress(f"mini-cell: cluster {victim} down "
                         f"({len(orphans)} registered)")
            # the rebalancer's next tick sees the death and fails it over
            rebalancer.tick()

        engine.start()
        _pump_cells(cells, engine, ledger, time.monotonic() + wait_timeout,
                    on_tick=on_tick)
        for cid, cell in cells.items():
            if cid == victim:
                continue
            cell["bs"].flush()
            cell["sched"].wait_for_inflight_bindings(timeout=30.0)
        wall = time.monotonic() - t_start
        # the engine sees binds through the watch fan-in: settle until
        # its bind ledger holds what the stores hold (bounded)
        want_bound = sum(
            1 for cid, cell in cells.items() if cid != victim
            for p in cell["store"].list_pods() if p.spec.node_name)
        settle_deadline = time.monotonic() + 10.0
        while time.monotonic() < settle_deadline:
            with engine._lock:
                got = len(engine._bind)
            if got >= want_bound:
                break
            time.sleep(0.02)
        per_cluster = _per_cluster_latency(engine, clusters)
        with engine._lock:
            bind_final = dict(engine._bind)
        stats = engine.finish()
        engine = None
        name_cluster: Dict[str, int] = {}
        for cid, cell in cells.items():
            if cid != victim:
                for p in cell["store"].list_pods():
                    name_cluster[p.metadata.name] = cid
        recovered = sum(
            1 for n in orphans_unbound
            if n in bind_final
            and bind_final[n][0] - t_kill_rel[0] <= RECOVERY_BUDGET_S)
        counters = fed_client.counters()
        res = {
            "scenario": scenario,
            "clusters": clusters,
            "injected": stats.injected,
            "ever_bound": stats.ever_bound,
            "lost": stats.lost,
            "send_errors": list(stats.send_errors),
            "wall_s": wall,
            "pods_per_s": stats.ever_bound / wall if wall > 0 else 0.0,
            "p50_arrival_to_bind_ms": round(
                stats.arrival_to_bind.get("p50", 0.0) * 1000),
            "p99_arrival_to_bind_ms": round(stats.latency_p99_ms()),
            "per_cluster": per_cluster,
            "per_cluster_slo_ok": all(
                v["p99_ms"] <= P99_PER_CLUSTER_BUDGET_MS
                for v in per_cluster.values() if v["bound"] > 0),
            "gang_splits": _gang_splits(name_cluster, trace),
            "gangs_total": stats.gangs_total,
            "gangs_partial": stats.gangs_partial,
            "spilled": counters["spilled"],
            "failovers": counters["failovers"],
            "failover_replaced": counters["failover_replaced"],
            "fallback_placements": counters["fallback_placements"],
            "victim": victim,
            "orphans_unbound_at_kill": len(orphans_unbound),
            "recovery_ratio": (recovered / len(orphans_unbound)
                               if orphans_unbound else 1.0),
            "rebalancer_actions": [a["action"]["op"]
                                   for a in rebalancer.actions],
            "batch_solves": sum(cell["bs"].session.backend.solves
                                for cell in cells.values()),
            "fed_solves": fed_sched.solves,
            "device": str(dev),
        }
        if record_decisions:
            res["decisions"] = fed_sched.decisions
        return res
    finally:
        if engine is not None:
            try:
                engine.finish()
            except Exception:  # noqa: BLE001 — teardown must not mask
                pass
        for cell in cells.values():
            cell["sched"].stop()
        gc.collect()


def run_degradation_differential(
    pods: int = 160,
    qps: float = 400.0,
    seed: int = 18,
    *,
    node_cpu: int = 16,
    max_batch: int = 64,
    wait_timeout: float = 120.0,
    device=None,
    progress: Optional[Callable[[str], None]] = None,
) -> dict:
    """The same trace through a one-cluster federation with the layer up
    and with it down (every create routed home): both arms must bind the
    identical set of pod names. The federation changes where work lands,
    never whether it binds."""
    dev = resolve_device(device)
    trace = build_federation_trace(seed, pods, qps, namespaces=4)
    samples = events_to_pods(trace.events[:64])
    sizing = _fleet_sizing(trace, 1, node_cpu, "spill")

    def arm(down: bool) -> Tuple[List[str], dict]:
        cells = {0: _inproc_cluster(0, sizing[0], max_batch, samples, dev)}
        ledger = CapacityLedger()
        home_map = HomeMap([0])
        fed_sched = FederationScheduler(ledger, home_of=home_map.home_of,
                                        device=dev)
        fed_sched.set_down(down)
        fed_client = FederatedClusterClient(
            {0: cells[0]["store"]}, fed_sched, ledger, home_map=home_map)
        ledger.refresh_from(0, cells[0]["store"].list_nodes(),
                            cells[0]["store"].list_pods())
        engine = None
        try:
            engine = ReplayEngine(fed_client, trace, time_scale=1.0,
                                  expire=False, progress=progress)
            engine.start()
            _pump_cells(cells, engine, ledger,
                        time.monotonic() + wait_timeout)
            cells[0]["bs"].flush()
            cells[0]["sched"].wait_for_inflight_bindings(timeout=30.0)
            stats = engine.finish()
            engine = None
            bound = sorted(p.metadata.name
                           for p in cells[0]["store"].list_pods()
                           if p.spec.node_name)
            return bound, {"lost": stats.lost,
                           "fallbacks": fed_client.fallback_placements}
        finally:
            if engine is not None:
                try:
                    engine.finish()
                except Exception:  # noqa: BLE001
                    pass
            cells[0]["sched"].stop()

    bound_on, on_meta = arm(down=False)
    bound_down, down_meta = arm(down=True)
    return {"bound_on": bound_on, "bound_down": bound_down,
            "identical": bound_on == bound_down,
            "on": on_meta, "down": down_meta}
