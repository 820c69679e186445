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

``run_federation_mini_cell`` runs one scenario in process; the device
(the card unless "cpu") carries every cell's batch solves and, with
``FederationPolicy(serial=False)``, the federation's decisions on the
scan.

``run_federation_storm`` runs one over the REST fabric: each cell a
spawned apiserver (the upgrade harness's partition child: WAL, tokens,
the counts protocol) and a one-replica scheduler fleet in this process
whose batch path runs on ``device``; cluster loss SIGKILLs a whole
cell's process. ``run_federation_row`` shapes a row from it,
``run_chaos_federation`` a seeded chaos cell; ``_federation_ok`` is the
verdict: lost pods, a gang split across clusters, a relist in a
surviving cell, a cluster's p99 over ``P99_PER_CLUSTER_BUDGET_MS`` or a
recovery ratio under ``RECOVERY_RATIO_FLOOR`` fail it.
"""

from __future__ import annotations

import gc
import math
import random
import threading
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


# ---------------------------------------------------------------------------
# the spawned storm over the REST fabric


class _FederationCells:
    """K independent spawned cells, each the upgrade harness's one-
    partition apiserver child; their scheduler fleets live in the
    parent."""

    def __init__(self, count: int):
        import multiprocessing as mp
        import tempfile

        self.count = count
        self.ctx = mp.get_context("spawn")
        self.wal_root = tempfile.mkdtemp(prefix="ktpu-federation-wal-")
        self.children: Dict[int, list] = {}
        self.urls: Dict[int, str] = {}

    def start(self, timeout: float = 60.0) -> Dict[int, str]:
        import os

        from kubernetes_tpu_torch.harness.rest_perf import _main_hidden
        from kubernetes_tpu_torch.harness.upgrade import (
            _upgrade_apiserver_main,
        )

        for cid in range(self.count):
            seg = os.path.join(self.wal_root, f"c{cid}")
            os.makedirs(seg, exist_ok=True)
            parent_conn, child_conn = self.ctx.Pipe()
            proc = self.ctx.Process(
                target=_upgrade_apiserver_main,
                args=(child_conn, 0, 1, seg, False, False),
                daemon=True)
            with _main_hidden():
                proc.start()
            self.children[cid] = [parent_conn, proc]
        for cid, (conn, _proc) in self.children.items():
            if not conn.poll(timeout):
                raise RuntimeError(f"federation cell {cid} did not come up")
            self.urls[cid] = conn.recv()
        return dict(self.urls)

    def kill(self, cid: int) -> None:
        """SIGKILL the whole cell: the cluster-loss seam."""
        _conn, proc = self.children[cid]
        proc.kill()
        proc.join(timeout=5.0)

    def counts(self, cid: int, timeout: float = 10.0) -> Optional[dict]:
        conn, proc = self.children[cid]
        if not proc.is_alive():
            return None
        try:
            conn.send("counts")
            if conn.poll(timeout):
                return conn.recv()
        except (BrokenPipeError, EOFError, OSError):
            pass
        return None

    def teardown(self) -> None:
        import shutil

        for conn, _proc in self.children.values():
            try:
                conn.send("stop")
            except (BrokenPipeError, OSError):
                pass
        for conn, proc in self.children.values():
            try:
                if conn.poll(3.0):
                    conn.recv()
            except (EOFError, OSError):
                pass
            proc.join(timeout=3.0)
            if proc.is_alive():
                proc.terminate()
        shutil.rmtree(self.wal_root, ignore_errors=True)


def run_federation_storm(
    *,
    clusters: int = 3,
    pods: int = 900,
    qps: float = FEDERATION_QPS,
    seed: int = 18,
    scenario: str = "spill",
    node_cpu: int = 16,
    max_batch: int = 256,
    wait_timeout: float = 600.0,
    progress: Optional[Callable[[str], None]] = None,
    device=None,
) -> dict:
    """One federation storm over spawned cells, each cell's scheduler
    batching on ``device`` (the card unless "cpu"). Returns the raw
    result; ``run_federation_row`` shapes the row and
    ``run_chaos_federation`` the chaos verdict."""
    from kubernetes_tpu_torch.client.restcluster import RestClusterClient
    from kubernetes_tpu_torch.harness.perf import (
        collect_freshness,
        reset_sli_window,
    )
    from kubernetes_tpu_torch.harness.upgrade import (
        CREATOR_TOKEN,
        SCHEDULER_TOKEN,
        _ReplicaFleet,
    )
    from kubernetes_tpu_torch.observability.devprof import get_devprof
    from kubernetes_tpu_torch.utils.gctune import tune_for_throughput

    if scenario not in FEDERATION_SCENARIOS:
        raise ValueError(
            f"unknown federation scenario {scenario!r} "
            f"(have: {', '.join(FEDERATION_SCENARIOS)})")
    dev = resolve_device(device)
    tune_for_throughput()
    get_tracer().clear()
    reset_sli_window()
    get_devprof().reset(workload=f"federation/{scenario}")
    rng = random.Random(seed)
    namespaces = 12
    trace = build_federation_trace(seed, pods, qps, namespaces=namespaces)
    sizing = _fleet_sizing(trace, clusters, node_cpu, scenario)

    cells = _FederationCells(clusters)
    all_clients: List = []
    fleets: Dict[int, object] = {}
    engine = None
    rebalancer = None
    probe_stop = threading.Event()

    try:
        urls = cells.start()

        def make_client(cid: int, token: str, watch_kinds=()):
            c = RestClusterClient(urls[cid], partition_urls=[urls[cid]],
                                  token=token, watch_kinds=watch_kinds,
                                  max_retries=4)
            all_clients.append(c)
            return c

        # each cell's creator client (the federation's create and watch
        # fabric) and probe client (the ledger's capacity poll)
        creators = {cid: make_client(cid, CREATOR_TOKEN,
                                     watch_kinds=("Pod",))
                    for cid in range(clusters)}
        probes = {cid: make_client(cid, CREATOR_TOKEN)
                  for cid in range(clusters)}

        for cid in range(clusters):
            nodes = [Node.from_dict(d) for d in
                     _cluster_nodes(cid, *sizing[cid])]
            for lo in range(0, len(nodes), 512):
                creators[cid].create_objects_bulk(
                    "Node", nodes[lo:lo + 512])
        if progress:
            progress(f"federation[{scenario}]: {clusters} cells, "
                     f"nodes per cluster {dict(sizing)}, "
                     f"{len(trace.events)} arrivals @ {qps:.0f}/s")

        # each cell's own scheduler: a one-replica fleet
        samples = events_to_pods(trace.events[:128])
        for cid in range(clusters):
            fleet = _ReplicaFleet(
                lambda j, _cid=cid: make_client(
                    _cid, SCHEDULER_TOKEN, watch_kinds=("Pod", "Node")),
                count=1, use_batch=True, max_batch=max_batch,
                progress=progress, device=dev)
            for sched in fleet.replicas:
                attach_slo_baseline(sched)
            fleet.run()
            fleets[cid] = fleet
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            if all(min(f.cache_nodes()) >= sizing[cid][0]
                   for cid, f in fleets.items()):
                break
            time.sleep(0.1)
        for fleet in fleets.values():
            fleet.warmup(samples)

        # the federation layer: the ledger (fed by the probe loop), the
        # scheduler, the client, the rebalancer
        ledger = CapacityLedger()
        home_map = HomeMap(list(range(clusters)), pin={
            f"fed-{i}": i % clusters for i in range(namespaces)})
        fed_sched = FederationScheduler(ledger, home_of=home_map.home_of,
                                        device=dev)
        fed_client = FederatedClusterClient(
            dict(creators), fed_sched, ledger, home_map=home_map)

        fail_count: Dict[int, int] = {cid: 0 for cid in range(clusters)}

        def probe_loop() -> None:
            while not probe_stop.wait(0.25):
                for cid in list(probes):
                    if not ledger.alive(cid):
                        continue
                    try:
                        ns = probes[cid].list_nodes()
                        ps = probes[cid].list_pods()
                        ledger.refresh_from(cid, ns, ps)
                        fail_count[cid] = 0
                    except Exception:  # noqa: BLE001 — the cell may be
                        fail_count[cid] += 1   # dead: two misses in a
                        if fail_count[cid] >= 2:   # row confirm it
                            ledger.mark_dead(cid)

        # one probe pass first, so placement starts informed
        for cid in range(clusters):
            ledger.refresh_from(cid, probes[cid].list_nodes(),
                                probes[cid].list_pods())
        probe = threading.Thread(target=probe_loop, daemon=True,
                                 name="federation-ledger-probe")
        probe.start()
        rebalancer = ClusterRebalancer(fed_client, interval_s=0.3)
        rebalancer.run()

        engine = ReplayEngine(fed_client, trace, time_scale=1.0,
                              expire=False, progress=progress)
        t_start = time.monotonic()
        engine.start()

        # ---- the seam: SIGKILL one whole cell mid-storm ----------------
        victim: Optional[int] = None
        t_kill_rel = 0.0
        orphans: List[str] = []
        orphans_unbound: List[str] = []
        if scenario in _KILL_AT:
            at = _KILL_AT[scenario] * trace.duration_s
            while time.monotonic() - t_start < at \
                    and not engine.injection_done.is_set():
                time.sleep(0.05)
            # spill-loss kills a cell that is not saturated: the spill
            # and the loss land on the same survivors
            victim = (rng.randrange(1, clusters)
                      if scenario == "spill-loss" and clusters > 1
                      else rng.randrange(clusters))
            with fed_client._lock:
                orphans = [name for (ns, name), cid
                           in fed_client._route.items() if cid == victim]
            with engine._lock:
                bound_now = set(engine._bind)
            orphans_unbound = [n for n in orphans if n not in bound_now]
            t_kill_rel = time.monotonic() - t_start
            if progress:
                progress(f"federation[{scenario}]: SIGKILL cluster "
                         f"{victim} ({len(orphans)} registered, "
                         f"{len(orphans_unbound)} unbound)")
            cells.kill(victim)
            # the dead cell's scheduler stops in the background: its
            # client calls may block on the dead socket
            threading.Thread(target=fleets.pop(victim).stop,
                             daemon=True).start()
            # the rebalancer sees the dead ledger and fails the cell
            # over; if it misses its window, fail over directly (the
            # invariant is the re-placement, not the messenger)
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                if any(a["action"]["op"] == "failover"
                       for a in rebalancer.actions):
                    break
                time.sleep(0.1)
            else:
                ledger.mark_dead(victim)
                fed_client.failover_cluster(victim, progress=progress)

        # ---- quiesce: every arrival bound ------------------------------
        want = len(trace.events)
        deadline = time.monotonic() + wait_timeout
        last_note = 0.0
        while time.monotonic() < deadline:
            with engine._lock:
                bound = len(engine._bind)
            if engine.injection_done.is_set() and bound >= want:
                break
            if progress and time.monotonic() - last_note > 10.0:
                last_note = time.monotonic()
                progress(f"federation[{scenario}]: {bound}/{want} bound")
            time.sleep(0.1)
        for fleet in fleets.values():
            fleet.flush()
        per_cluster = _per_cluster_latency(engine, clusters)
        with engine._lock:
            bind_final = dict(engine._bind)
        stats = engine.finish()
        engine = None
        time.sleep(0.5)

        # ---- invariants, from the surviving cells' own stores ----------
        name_cluster: Dict[str, int] = {}
        server_bound = 0
        children_torch = False
        for cid in range(clusters):
            if cid == victim:
                continue
            counts = cells.counts(cid)
            if counts is None:
                continue
            children_torch |= counts["import_torch"]
            for ns, name, _rv, is_bound in counts["pods"]:
                name_cluster[name] = cid
                if is_bound:
                    server_bound += 1
        gang_splits = _gang_splits(name_cluster, trace)
        # recovery: of the victim's pods unbound at the kill, those bound
        # again on a survivor within the budget
        recovered = 0
        for n in orphans_unbound:
            rec = bind_final.get(n)
            if rec is not None \
                    and rec[0] - t_kill_rel <= RECOVERY_BUDGET_S:
                recovered += 1
        recovery_ratio = (recovered / len(orphans_unbound)
                          if orphans_unbound else 1.0)
        # relist confinement: the surviving cells' streams never relist
        survivor_relists = 0
        for cid in range(clusters):
            if cid == victim:
                continue
            survivor_relists += sum(creators[cid].stream_relists.values())
        for cid, fleet in fleets.items():
            for sched in fleet.replicas:
                survivor_relists += sum(
                    sched.client.stream_relists.values())
        fresh = collect_freshness(
            get_devprof().summary() if get_devprof().enabled else None)
        slo = (fresh or {}).get("slo") or {}
        counters = fed_client.counters()
        result = {
            "scenario": scenario,
            "seed": seed,
            "device": str(dev),
            "clusters": clusters,
            "qps": qps,
            "injected": stats.injected,
            "ever_bound": stats.ever_bound,
            "server_bound": server_bound,
            "lost_pods": stats.lost,
            "send_errors": list(stats.send_errors),
            "p99_arrival_to_bind_ms": round(stats.latency_p99_ms()),
            "p50_arrival_to_bind_ms": round(
                stats.arrival_to_bind.get("all", {}).get("p50", 0.0)
                * 1000),
            "last_bind_s": stats.last_bind_s,
            "offered_rate": stats.offered_rate,
            "per_cluster": per_cluster,
            "per_cluster_slo_ok": all(
                v["p99_ms"] <= P99_PER_CLUSTER_BUDGET_MS
                for v in per_cluster.values() if v["bound"] > 0),
            "gangs_total": len({e.gang for e in trace.events if e.gang}),
            "gang_splits": gang_splits,
            "spilled": counters["spilled"],
            "fallback_placements": counters["fallback_placements"],
            "failovers": counters["failovers"],
            "failover_replaced": counters["failover_replaced"],
            "victim": victim,
            "orphans": len(orphans),
            "orphans_unbound_at_kill": len(orphans_unbound),
            "recovered_in_budget": recovered,
            "recovery_budget_s": RECOVERY_BUDGET_S,
            "recovery_ratio": round(recovery_ratio, 3),
            "survivor_relists": survivor_relists,
            "rebalancer_actions": [a["action"]["op"]
                                   for a in rebalancer.actions],
            "children_import_torch": children_torch,
            "freshness": fresh,
            "slo_verdicts_ok": (all(v == "ok" for v in slo.values())
                                if slo else None),
        }
        # ---- the fleet trace across the cross-cluster hop --------------
        try:
            from kubernetes_tpu_torch.observability.fleettrace import (
                collect_fleet_trace,
            )

            doc, cp = collect_fleet_trace(
                remote=[(f"cluster-{cid}", urls[cid])
                        for cid in range(clusters) if cid != victim],
                local=[("federation", get_tracer())],
                token=SCHEDULER_TOKEN, max_pods=25)
            result["fleet_trace_doc"] = doc
            result["critical_path"] = cp
        except Exception:  # noqa: BLE001 — tracing must not fail a row
            pass
        return result
    finally:
        probe_stop.set()
        if rebalancer is not None:
            rebalancer.stop()
        if engine is not None:
            try:
                engine.finish()
            except Exception:  # noqa: BLE001 — teardown must not mask
                pass
        for fleet in fleets.values():
            try:
                fleet.stop()
            except Exception:  # noqa: BLE001
                pass
        for c in all_clients:
            try:
                c._stop_watches()
                c._drop_conn()
            except Exception:  # noqa: BLE001
                pass
        cells.teardown()
        gc.collect()


def _federation_diag(res: dict) -> None:
    import sys

    from kubernetes_tpu_torch.harness import diagfmt

    seg = diagfmt.format_federation({
        "clusters": res["clusters"],
        "spilled": res["spilled"],
        "failovers": res["failovers"],
        "lost": res["lost_pods"],
        "recovery": res["recovery_ratio"],
    })
    if seg:
        print(diagfmt.format_diag([seg]), file=sys.stderr, flush=True)


def run_federation_row(
    pods: int = 900,
    qps: float = FEDERATION_QPS,
    seed: int = 18,
    *,
    mode: str = "spill",
    clusters: int = 3,
    node_cpu: int = 16,
    max_batch: int = 256,
    wait_timeout: float = 600.0,
    progress: Optional[Callable[[str], None]] = None,
    device=None,
) -> dict:
    """One federation row over REST, ``mode`` "spill" or "loss" (the
    loss-mid scenario): the rate to the last bind, normalized by the
    offered rate, each cluster's p99 arrival-to-bind, and the verdict of
    ``_federation_ok``."""
    scenario = "loss-mid" if mode == "loss" else mode
    res = run_federation_storm(
        clusters=clusters, pods=pods, qps=qps, seed=seed,
        scenario=scenario, node_cpu=node_cpu, max_batch=max_batch,
        wait_timeout=wait_timeout, progress=progress, device=device)
    ok, why = _federation_ok(res)
    value = (res["ever_bound"] / res["last_bind_s"]
             if res["last_bind_s"] > 0 else 0.0)
    offered = res["offered_rate"]
    label = ("cluster-loss SIGKILL" if res["victim"] is not None
             else "saturation spillover")
    row = {
        "metric": (
            f"federation_{mode}[open-loop {qps:.0f}/s "
            f"{clusters}clusters {label}, {pods}pods seed={seed}, "
            f"REST fabric]"),
        "value": round(value, 1),
        "unit": "pods/s",
        "device": res["device"],
        "offered_rate_pods_per_sec": round(offered, 2),
        "rate_normalized_throughput": round(
            value / offered, 3) if offered > 0 else 0.0,
        "p99_arrival_to_bind_ms": res["p99_arrival_to_bind_ms"],
        "p50_arrival_to_bind_ms": res["p50_arrival_to_bind_ms"],
        "per_cluster": res["per_cluster"],
        "per_cluster_slo_ok": res["per_cluster_slo_ok"],
        "injected": res["injected"],
        "ever_bound": res["ever_bound"],
        "lost_pods": res["lost_pods"],
        "gang_splits": res["gang_splits"],
        "spilled": res["spilled"],
        "failovers": res["failovers"],
        "failover_replaced": res["failover_replaced"],
        "recovery_ratio": res["recovery_ratio"],
        "survivor_relists": res["survivor_relists"],
        "fallback_placements": res["fallback_placements"],
        "children_import_torch": res["children_import_torch"],
        "invariants_ok": ok,
        "invariants": {"failed": why} if why else {},
    }
    fresh = res.get("freshness") or {}
    if fresh:
        row["freshness"] = fresh
        slo = fresh.get("slo") or {}
        row["slo_verdicts_ok"] = res["slo_verdicts_ok"]
        row["slo_gated"] = sorted(slo)
    cp = res.get("critical_path")
    if cp:
        row["critical_path"] = {k: v for k, v in cp.items()
                                if k != "per_pod"}
    _federation_diag(res)
    if progress:
        progress(f"[federation/{mode}] {res['ever_bound']}/"
                 f"{res['injected']} bound, spilled {res['spilled']}, "
                 f"failovers {res['failovers']}, recovery "
                 f"{res['recovery_ratio']:.2f}, lost "
                 f"{res['lost_pods']}, "
                 f"{'OK' if ok else 'FAILED: ' + why}")
    return row


def run_chaos_federation(seed: int, pods: int = 400,
                         wait_timeout: float = 300.0,
                         progress: Optional[Callable] = None,
                         scenario: str = "loss-mid", device=None) -> Dict:
    """One seeded (scenario x seed) cell: the kill's timing, the victim
    (chosen by the seed) and the spill load, over 3 spawned cells."""
    if scenario not in FEDERATION_SCENARIOS:
        raise ValueError(
            f"unknown federation scenario {scenario!r} "
            f"(have: {', '.join(FEDERATION_SCENARIOS)})")
    res = run_federation_storm(
        clusters=3, pods=pods, qps=max(100.0, pods / 4.0), seed=seed,
        scenario=scenario, node_cpu=16, max_batch=256,
        wait_timeout=wait_timeout, progress=progress, device=device)
    ok, why = _federation_ok(res)
    return {
        "seed": seed, "profile": scenario, "ok": ok,
        "failure": "" if ok else (
            f"{why} lost={res['lost_pods']} "
            f"splits={res['gang_splits']} "
            f"relists={res['survivor_relists']} "
            f"recovery={res['recovery_ratio']}"),
        "stats": {
            "injected": res["injected"],
            "ever_bound": res["ever_bound"],
            "spilled": res["spilled"],
            "failovers": res["failovers"],
            "victim": res["victim"],
            "orphans": res["orphans"],
            "recovery_ratio": res["recovery_ratio"],
            "p99_arrival_to_bind_ms": res["p99_arrival_to_bind_ms"],
        },
    }


# ---------------------------------------------------------------------------
# the in-process cells


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
                stats.arrival_to_bind["all"]["p50"] * 1000),
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
