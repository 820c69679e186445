"""The replay rows and chaos cells: the scenario families measured
through the REST fabric, judged by invariants and SLO verdicts.

``run_replay_row`` runs one family open-loop over the REST fabric (an
apiserver process with the WAL, RBAC and APF; arrivals through
authenticated clients; the scheduler fed by watch streams, its solves
on the card) and returns a row whose headline is arrival -> bind
latency, the time a submitter waits for one pod, beside the throughput
normalized by the offered rate, the family's invariants, the SLO
verdicts and the ``replay[...]`` diag segment. By family:

- ``gangs`` runs two arms, MeshLocality scored and adjacency-blind, on
  the same trace; the scored arm's mean gang adjacency must be lower;
- ``tenancy`` runs the cluster autoscaler (node-group capacity bought
  during the trace, its what-ifs on the scan kernel) with APF: each
  tenant's pods go through its own authenticated client, so serve and
  batch are separate flows; the row splits arrival -> bind by class;
- ``storm`` reports the preemptions and the no-priority-inversion
  verdict at quiesce.

``run_replay_cell`` is the chaos matrix's cell: a store-direct mini
replay of one (family, seed) holding the invariants (zero lost pods,
gang atomicity, no priority inversion).

The apiserver child imports the fabric's modules only (no torch).
"""

from __future__ import annotations

import math
import multiprocessing as mp
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

from kubernetes_tpu_torch.workloads.scenarios import (
    REPLAY_FAMILIES,
    TENANCY_NODE_CPU,
    FamilySpec,
    _tenancy_sizing,
)
from kubernetes_tpu_torch.workloads.trace import Trace

SCHEDULER_TOKEN = "replay-scheduler-token"
CREATOR_TOKEN = "replay-creator-token"
SERVE_LATENCY_BUDGET_S = 2.0
# what a replay tenant may do: submit and withdraw its own pods
REPLAY_TENANT_RULES = ((("get", "list", "watch", "create", "delete"),
                        ("pods",)),)


def tenant_tokens(spec: FamilySpec) -> Dict[str, str]:
    """Bearer token -> user of each of the family's tenants."""
    return {f"{t}-token": t for t in spec.tenants}


# ---------------------------------------------------------------------------
# the apiserver child (spawned; it imports no torch)


def _apiserver_main(conn, wal_dir: Optional[str],
                    extra_tokens: Optional[dict] = None) -> None:
    """The REST row's apiserver, but the replay tenants may create and
    delete pods: they are users of the fabric, not read-only load."""
    from kubernetes_tpu_torch.apiserver.rbac import provision_bootstrap_policy
    from kubernetes_tpu_torch.apiserver.rest import APIServer
    from kubernetes_tpu_torch.apiserver.store import ClusterStore
    from kubernetes_tpu_torch.apiserver.wal import attach_wal
    from kubernetes_tpu_torch.harness.rest_perf import grant_tenants
    from kubernetes_tpu_torch.utils.gctune import tune_for_throughput

    tune_for_throughput()
    store = ClusterStore()
    wal = attach_wal(store, wal_dir, snapshot_every=200_000,
                     async_serialize=True) \
        if wal_dir else None
    authz = provision_bootstrap_policy(store)
    authz.add_user_to_group("replay-creator", "system:masters")
    tokens = {SCHEDULER_TOKEN: "system:kube-scheduler",
              CREATOR_TOKEN: "replay-creator"}
    if extra_tokens:
        tokens.update(extra_tokens)
        grant_tenants(store, "replay-tenant", extra_tokens,
                      REPLAY_TENANT_RULES)
    server = APIServer(store=store, authorizer=authz, tokens=tokens).start()
    conn.send(server.url)
    while True:
        msg = conn.recv()
        if msg == "stop":
            break
        if msg == "counts":
            pods = store.list_pods()
            if wal is not None:
                wal.drain()
            conn.send({
                "pods_total": len(pods),
                "pods_bound": sum(1 for p in pods if p.spec.node_name),
                "nodes": len(store.list_nodes()),
                "import_torch": "torch" in sys.modules,
            })
    server.shutdown_server()
    if wal is not None:
        wal.close()
    conn.send("stopped")


# ---------------------------------------------------------------------------
# one replay run (store-direct or REST)


def _pump_to_quiesce(sched, bs, engine, deadline: float,
                     settle_s: float = 1.0) -> None:
    """Drive the scheduler until the replay is over: the trace sent, the
    due expiries delivered, the queue's active pods drained, and no
    progress for ``settle_s`` (a deletion wakes parked pods, so quiet
    must hold for a while, not an instant)."""
    quiet_since = None
    while time.monotonic() < deadline:
        sched.queue.flush_backoff_completed()
        progressed = bs.run_batch(pop_timeout=0.01)
        now = time.monotonic()
        if progressed:
            quiet_since = None
            continue
        busy = (not engine.injection_done.is_set()
                or engine.due_expiries() > 0
                or sched.queue.pending_active_count() > 0)
        if busy:
            quiet_since = None
        elif quiet_since is None:
            quiet_since = now
        elif now - quiet_since >= settle_s:
            return
        time.sleep(0.005)
    raise TimeoutError("the replay did not quiesce before the deadline")


def _close_all(clients) -> None:
    for c in clients:
        try:
            c.close()
        except Exception:  # noqa: BLE001 — teardown goes on
            pass


def run_replay_once(
    family: str,
    seed: int = 11,
    scale: float = 1.0,
    time_scale: float = 1.0,
    *,
    rest: bool = False,
    max_batch: int = 1024,
    qps: Optional[float] = 5000.0,
    wait_timeout: float = 600.0,
    scored: bool = True,
    trace: Optional[Trace] = None,
    progress: Optional[Callable[[str], None]] = None,
    device=None,
):
    """One replay run, the batch path's solves on ``device`` (the card
    unless "cpu" is passed). Returns ``(stats, extras)``: ``extras``
    holds the telemetry and freshness summaries, the apiserver's own
    counts of a REST run (``server``), and the autoscaler's and APF's
    ledgers where they ran. ``scored=False`` is the adjacency-blind
    arm."""
    from kubernetes_tpu_torch.api.types import Node
    from kubernetes_tpu_torch.config.feature_gates import FeatureGates
    from kubernetes_tpu_torch.device import resolve_device
    from kubernetes_tpu_torch.harness.perf import (
        attach_slo_baseline,
        collect_freshness,
        reset_sli_window,
    )
    from kubernetes_tpu_torch.observability.devprof import get_devprof
    from kubernetes_tpu_torch.observability.slo import get_slo_engine
    from kubernetes_tpu_torch.observability.tracer import get_tracer
    from kubernetes_tpu_torch.scheduler.framework.plugins import mesh_locality
    from kubernetes_tpu_torch.scheduler.scheduler import Scheduler
    from kubernetes_tpu_torch.sidecar import attach_batch_scheduler
    from kubernetes_tpu_torch.utils.gctune import tune_for_throughput
    from kubernetes_tpu_torch.workloads.replay import ReplayEngine
    from kubernetes_tpu_torch.workloads.trace import events_to_pods

    spec = REPLAY_FAMILIES[family]
    dev = resolve_device(device)
    autoscale = spec.autoscale
    if trace is None:
        trace = spec.build(seed, scale)
    tune_for_throughput()
    get_tracer().clear()
    get_devprof().reset(workload=f"replay/{family}")
    reset_sli_window()
    prev_scored = mesh_locality.enabled()
    mesh_locality.configure(scored)

    extras: Dict = {"family": family, "seed": seed, "scale": scale,
                    "device": str(dev)}
    api_conn = api_proc = None
    wal_dir = None
    clients: List = []
    ca = factory = None
    engine = None
    sched = None
    slo_engine = get_slo_engine()
    try:
        if rest:
            from kubernetes_tpu_torch.client.restcluster import (
                RestClusterClient,
            )
            from kubernetes_tpu_torch.harness.rest_perf import (
                CHILD_START_S,
                _main_hidden,
            )

            ctx = mp.get_context("spawn")
            wal_dir = tempfile.mkdtemp(prefix="ktpu-replay-wal-")
            api_conn, api_child = ctx.Pipe()
            api_proc = ctx.Process(
                target=_apiserver_main,
                args=(api_child, wal_dir, tenant_tokens(spec)),
                daemon=True)
            with _main_hidden():
                api_proc.start()
            if not api_conn.poll(CHILD_START_S):
                raise RuntimeError("the apiserver child did not start")
            url = api_conn.recv()

            def connect(token: str, **kw):
                c = RestClusterClient(url, token=token, qps=qps, **kw)
                clients.append(c)
                return c

            client = connect(SCHEDULER_TOKEN)
            event_client = connect(SCHEDULER_TOKEN)
            creator = connect(CREATOR_TOKEN)
            # tenants speak JSON: the server decodes binary bodies only
            # from the control plane
            tenant_clients = {t: connect(token, binary=False)
                              for token, t in tenant_tokens(spec).items()}
            target, sched_client = creator, client
        else:
            from kubernetes_tpu_torch.apiserver.store import ClusterStore

            store = ClusterStore()
            target = sched_client = store
            event_client = None
            tenant_clients = {}

        # -- the node fleet (owned by a node group when the autoscaler
        #    plays) --
        if autoscale:
            from kubernetes_tpu_torch.autoscaler.nodegroups import (
                NodeGroup,
                NodeGroupRegistry,
            )

            _, _, initial = _tenancy_sizing(scale)
            need = max(initial + 1, math.ceil(initial / 0.45))
            registry = NodeGroupRegistry()
            group = registry.add(NodeGroup(
                "ng-replay", cpu=str(TENANCY_NODE_CPU), memory="32Gi",
                min_size=initial, max_size=need + 4, boot_latency=0.4))
            initial_nodes = [group.node_template(i) for i in range(initial)]
        else:
            registry = None
            initial_nodes = [Node.from_dict(d)
                             for d in spec.node_specs(scale)]
        if rest:
            target.create_objects_bulk("Node", initial_nodes)
        else:
            for n in initial_nodes:
                target.add_node(n)

        # -- the scheduler (the gang provider: every family's gangs ride
        #    the coscheduling machinery) --
        sched = Scheduler.create(
            sched_client, provider="GangSchedulingProvider",
            feature_gates=FeatureGates({"TPUBatchScheduler": True}),
            event_client=event_client)
        bs = attach_batch_scheduler(sched, max_batch=max_batch, device=dev)
        attach_slo_baseline(sched)
        if rest and slo_engine.enabled:
            slo_engine.start(interval_s=1.0)
        sched.start()
        if rest:
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline and \
                    sched.cache.node_count() < len(initial_nodes):
                time.sleep(0.02)
        samples = events_to_pods(trace.events[:128])
        warm = bs.warmup(samples) if samples else 0.0
        if progress and warm > 0.05:
            progress(f"replay/{family}: solver warmup {warm:.1f}s")

        # -- the autoscaler (the tenancy family buys capacity); over
        #    REST it reads and provisions through the fabric as a
        #    masters identity --
        if autoscale:
            from kubernetes_tpu_torch.autoscaler.controller import (
                ClusterAutoscaler,
            )
            from kubernetes_tpu_torch.client.informers import (
                SharedInformerFactory,
            )

            ca_client = connect(CREATOR_TOKEN) if rest else target
            factory = SharedInformerFactory(ca_client)
            ca = ClusterAutoscaler(ca_client, factory, registry=registry,
                                   device=dev)
            ca.RESYNC_SECONDS = 0.2
            ca.scale_up_cooldown = 0.5
            ca.max_virtual_per_group = 128
            ca.scale_down_enabled = False
            ca.queue_introspect = sched.queue
            factory.start()
            factory.wait_for_cache_sync()
            ca.run()

        # -- the replay --
        engine = ReplayEngine(
            target, trace, time_scale=time_scale,
            tenant_targets=tenant_clients or None, progress=progress)
        t0 = time.monotonic()
        engine.start()
        _pump_to_quiesce(sched, bs, engine, time.monotonic() + wait_timeout)
        bs.flush()
        if not sched.wait_for_inflight_bindings(timeout=30.0):
            raise TimeoutError(f"replay/{family}: binds still in flight")
        extras["wall_s"] = round(time.monotonic() - t0, 2)
        stats = engine.finish()
        engine = None

        # -- observability --
        if rest:
            from kubernetes_tpu_torch.metrics import default_registry
            from kubernetes_tpu_torch.metrics.federation import (
                metrics_federation,
            )

            fed = metrics_federation()
            fed.forget_instance("apiserver")
            fed.forget_instance("scheduler")
            fed.scrape(url, instance="apiserver", token=SCHEDULER_TOKEN,
                       fold=True)
            fed.absorb_registry(default_registry(), instance="scheduler")
            extras["federation_instances"] = sorted(fed.instances())
            code, snap = client._request("GET", "/debug/apf")
            if code == 200 and isinstance(snap, dict):
                levels = snap.get("levels") or {}
                extras["apf"] = {
                    "rejections": sum(sum((lv.get("rejected") or {})
                                          .values())
                                      for lv in levels.values()),
                    "dispatched": {k: lv.get("dispatched_total", 0)
                                   for k, lv in levels.items()}}
        if ca is not None:
            extras["autoscaler"] = {
                "scaleup_decisions": ca.scale_up_events,
                "nodes_provisioned": ca.provisioner.provisioned_total,
                "whatif_solves": ca.whatif_solves,
                "nodes_end": len(target.list_nodes()),
            }
        dp = get_devprof()
        extras["telemetry"] = dp.summary() if dp.enabled else {}
        extras["freshness"] = collect_freshness(extras["telemetry"])
        extras["p99_e2e_ms"] = round(
            sched.metrics.e2e_scheduling_duration.quantile(
                0.99, "scheduled") * 1000, 1)
        extras["solves"] = bs.session.backend.solves
        if rest:
            api_conn.send("counts")
            if not api_conn.poll(60.0):
                raise RuntimeError("the apiserver child did not report")
            extras["server"] = api_conn.recv()
        return stats, extras
    finally:
        mesh_locality.configure(prev_scored)
        if engine is not None:
            try:
                engine.finish()
            except Exception:  # noqa: BLE001 — teardown goes on
                pass
        if ca is not None:
            ca.stop()
        if factory is not None:
            factory.stop()
        if rest and slo_engine.enabled:
            slo_engine.stop()
        if sched is not None:
            sched.stop()
        _close_all(clients)
        if api_conn is not None:
            try:
                api_conn.send("stop")
                if api_conn.poll(5.0):
                    api_conn.recv()
            except (OSError, EOFError):
                pass
            api_proc.join(timeout=5.0)
            if api_proc.is_alive():
                api_proc.terminate()
                api_proc.join(timeout=5.0)
        if wal_dir:
            import shutil

            shutil.rmtree(wal_dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# the family verdicts


def family_verdicts(spec: FamilySpec, stats,
                    serve_budget_s: float = SERVE_LATENCY_BUDGET_S
                    ) -> Dict[str, bool]:
    """The family's invariants over a run's stats (``adjacency`` is
    judged by the row, which has both arms)."""
    out: Dict[str, bool] = {}
    for check in spec.checks:
        if check == "lost":
            # the whole pipeline: every event was sent (no swallowed
            # send failure) and every sent pod is accounted for
            out["zero_lost_pods"] = (
                stats.lost == 0
                and stats.injected == stats.expected
                and not stats.send_errors)
        elif check == "inversion":
            out["no_priority_inversion"] = \
                stats.priority_inversions == 0
        elif check == "gangs":
            out["gang_atomicity"] = stats.gangs_partial == 0
        elif check == "serve_latency":
            # a run where no serve pod bound fails, rather than passing
            # on a p99 of 0
            lat = stats.arrival_to_bind.get("serve") or {}
            out["serve_p99_within_budget"] = (
                lat.get("count", 0) > 0
                and lat.get("p99", 0.0) <= serve_budget_s)
    return out


def _replay_diag(stats) -> None:
    from kubernetes_tpu_torch.harness import diagfmt

    seg = diagfmt.format_replay({
        "family": stats.family,
        "rate": stats.offered_rate,
        "p99_arrival_to_bind_ms": stats.latency_p99_ms(),
        "preempted": stats.preempted,
        "gangs_intact": stats.gangs_partial == 0,
        "lost": stats.lost,
        "expired": stats.expired,
        "inversions": stats.priority_inversions,
    })
    print(diagfmt.format_diag([seg]), file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# the row


def run_replay_row(
    family: str,
    seed: int = 11,
    scale: float = 1.0,
    time_scale: float = 1.0,
    *,
    rest: bool = True,
    max_batch: int = 1024,
    qps: Optional[float] = 5000.0,
    wait_timeout: float = 900.0,
    progress: Optional[Callable[[str], None]] = None,
    device=None,
) -> dict:
    """One replay row (``bench.py --config replay:<family>``). The gangs
    family runs the scored and the adjacency-blind arms; the row's
    verdicts are the family's invariants and the SLO verdicts not in
    the family's ``slo_exempt``."""
    spec = REPLAY_FAMILIES[family]
    trace = spec.build(seed, scale)

    def note(msg: str) -> None:
        if progress:
            progress(f"[replay:{family}] {msg}")

    note(f"{len(trace.events)} arrivals over "
         f"{trace.duration_s * time_scale:.0f}s "
         f"(offered {trace.offered_rate / max(time_scale, 1e-9):.1f} "
         f"pods/s), seed {seed}, "
         f"{'REST fabric' if rest else 'store-direct'}")
    stats, extras = run_replay_once(
        family, seed, scale, time_scale, rest=rest,
        max_batch=max_batch, qps=qps, wait_timeout=wait_timeout,
        trace=trace, progress=progress, device=device)
    _replay_diag(stats)
    verdicts = family_verdicts(spec, stats)
    offered = stats.offered_rate
    value = (stats.ever_bound / stats.last_bind_s
             if stats.last_bind_s > 0 else 0.0)
    n_nodes = len(spec.node_specs(scale))
    row = {
        "metric": (
            f"replay_{family}[{spec.title}, {n_nodes}nodes/"
            f"{len(trace.events)}pods offered "
            f"{offered:.1f}/s seed={seed}, "
            f"{'REST fabric' if rest else 'store-direct'} open-loop]"),
        "value": round(value, 1),
        "unit": "pods/s",
        "device": extras["device"],
        "offered_rate_pods_per_sec": round(offered, 2),
        "rate_normalized_throughput": round(
            value / offered, 3) if offered > 0 else 0.0,
        "p99_arrival_to_bind_ms": round(stats.latency_p99_ms()),
        "p50_arrival_to_bind_ms": round(
            stats.arrival_to_bind.get("all", {}).get("p50", 0.0) * 1000),
        "injected": stats.injected,
        "ever_bound": stats.ever_bound,
        "expired": stats.expired,
        "preempted": stats.preempted,
        "pending_at_end": stats.pending_at_end,
        "lost_pods": stats.lost,
        "priority_inversions": stats.priority_inversions,
        "gangs": {"total": stats.gangs_total,
                  "placed": stats.gangs_placed,
                  "partial": stats.gangs_partial},
        "latency_by_class_ms": {
            cls: {"p50": round(v.get("p50", 0.0) * 1000),
                  "p99": round(v.get("p99", 0.0) * 1000)}
            for cls, v in stats.arrival_to_bind.items()
            if cls != "all"},
        "invariants": verdicts,
        "invariants_ok": all(verdicts.values()),
        "wall_s": extras.get("wall_s"),
        "solves": extras.get("solves", 0),
    }
    fresh = extras.get("freshness") or {}
    if fresh:
        row["freshness"] = fresh
        slo = fresh.get("slo") or {}
        gated = {n: v for n, v in slo.items() if n not in spec.slo_exempt}
        row["slo_verdicts_ok"] = (
            all(v == "ok" for v in gated.values()) if gated else None)
        row["slo_gated"] = sorted(gated)
    if extras.get("telemetry"):
        row["telemetry"] = extras["telemetry"]
    for key in ("federation_instances", "autoscaler", "apf", "server"):
        if extras.get(key):
            row[key] = extras[key]
    if family == "gangs":
        note("adjacency-blind baseline arm")
        blind_stats, blind_extras = run_replay_once(
            family, seed, scale, time_scale, rest=rest,
            max_batch=max_batch, qps=qps, wait_timeout=wait_timeout,
            trace=trace, scored=False, progress=progress, device=device)
        _replay_diag(blind_stats)
        scored_adj = stats.mean_gang_adjacency
        blind_adj = blind_stats.mean_gang_adjacency
        row["adjacency_ab"] = {
            "scored_mean_gang_adjacency": round(scored_adj, 3)
            if scored_adj is not None else None,
            "blind_mean_gang_adjacency": round(blind_adj, 3)
            if blind_adj is not None else None,
            "scored_beats_blind": (
                scored_adj is not None and blind_adj is not None
                and scored_adj < blind_adj),
        }
        row["blind"] = {
            "lost_pods": blind_stats.lost,
            "gangs_partial": blind_stats.gangs_partial,
            "invariants": family_verdicts(spec, blind_stats),
            "p99_arrival_to_bind_ms": round(blind_stats.latency_p99_ms()),
            "solves": blind_extras.get("solves", 0),
            "server": blind_extras.get("server"),
        }
        # the A/B verdict joins the invariants dict, so the dict and the
        # rolled-up bool never disagree
        row["invariants"]["adjacency_scored_beats_blind"] = \
            row["adjacency_ab"]["scored_beats_blind"]
        row["invariants_ok"] = all(row["invariants"].values())
    note(f"{stats.ever_bound}/{stats.injected} bound, p99 "
         f"arrival->bind {row['p99_arrival_to_bind_ms']}ms, "
         f"preempted {stats.preempted}, lost {stats.lost}, "
         f"invariants_ok {row['invariants_ok']}")
    return row


# ---------------------------------------------------------------------------
# the chaos cell


def run_replay_cell(
    seed: int,
    family: str = "storm",
    nodes: int = 0,
    pods: int = 120,
    wait_timeout: float = 180.0,
    progress: Optional[Callable[[str], None]] = None,
    device=None,
) -> dict:
    """One (family, seed) chaos cell: a compressed store-direct mini
    replay holding the family's invariants. Its size is the family's
    scale, the larger of ``pods`` over the full traces' ~1,200 pods and
    ``nodes`` over the storm's 120 nodes: the family's node-to-pod
    ratio is part of its shape, so the knobs set scale, not counts."""
    scale = min(1.0, max(0.05, pods / 1200.0, nodes / 120.0))
    spec = REPLAY_FAMILIES[family]
    stats, _extras = run_replay_once(
        family, seed, scale, time_scale=0.2, rest=False,
        max_batch=256, wait_timeout=wait_timeout, progress=progress,
        device=device)
    verdicts = family_verdicts(spec, stats)
    failures = [k for k, v in verdicts.items() if not v]
    return {
        "seed": seed,
        "profile": family,
        "ok": all(verdicts.values()),
        "failure": ", ".join(failures),
        "stats": {
            "injected": stats.injected,
            "ever_bound": stats.ever_bound,
            "expired": stats.expired,
            "preempted": stats.preempted,
            "lost": stats.lost,
            "gangs_partial": stats.gangs_partial,
            "inversions": stats.priority_inversions,
            "p99_arrival_to_bind_ms": round(stats.latency_p99_ms()),
        },
    }
