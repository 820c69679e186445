"""Rolling-upgrade orchestrator: the fleet never stops serving.

Production fleets are never all one version — upstream Kubernetes
certifies an N/N−1 skew contract and rolls one process at a time. This
harness is that scenario for our control plane: every partition
apiserver AND every scheduler replica restarts exactly once while the
replay engine keeps open-loop arrivals flowing, and the roll is
judged by the same invariants the reshard chaos family established —
zero lost pods, zero lost/duplicated watch events, zero relists of
unmoved slices, a single topology epoch at quiesce.

The roll state machine, per partition (make-before-break):

1. **standby** — a replacement process is pre-spawned PAUSED (imports
   paid, not serving), so the serving gap is the WAL restore, never the
   Python spawn.
2. **drain** — the partition's owned slots FREEZE (the reshard
   coordinator's freeze, bounded ETA): writers get 429+Retry-After,
   in-flight mutations
   settle into the synchronous WAL. ``_verify_frozen`` before the cut:
   a drain that outlives its freeze budget ABORTS — unfreeze, old
   process keeps serving, the roll records the abort and retries with a
   doubled budget (the abort-and-rollback contract).
3. **cut** — the old process stops (or is SIGKILLed, in the chaos
   cells: the crash-consistent path restores identically), the standby
   restores the WAL segment and serves at a fresh URL.
4. **reroute** — ``reroute_after_restart`` bumps the topology epoch;
   every elastic client re-points its streams and rides its
   ``CompositeCursor`` across the seam (handoff fetch, never a relist
   of unmoved slices).

Scheduler replicas roll the same way: the replacement replica warms
its informers and queue shard via ``Scheduler.start()`` (the
leader-election standby discipline) while the old replica still binds;
the cut stops the old loop — its in-flight bindings finish, and a
replica race's loser unwinds through unreserve/forget/requeue — and
starts the new loop with a warm cache. The replicas share nodes, so a
placement a sibling filled since the solve is refused at commit; over
the REST client (no bind-time ledger) the fleet's replicas, standbys
and successors included, hold one commit lock from the probe to the
bind. Their batch paths run on ``device`` (the card unless "cpu").

Mixed-version wire guard: every client stamps the codec version it
speaks (``codec.VERSION_HEADER``); servers pin ``min(server, client)``
and echo it. The roll drives one client pinned to the OLD stamp for
the duration, and every client re-negotiates across each restart seam
(``codec_renegotiations``); a contract violation (``codec_failures``)
fails the row.

``_upgrade_ok`` is the row's verdict: lost pods or events, a red SLO
verdict, a partition over its freeze budget, relists of unmoved slices,
codec failures, or a process that did not restart exactly once fail
it. The spawned partition servers and standbys import no torch.
"""

from __future__ import annotations

import json
import os
import random
import shutil
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.client.restcluster import RestClusterClient
from kubernetes_tpu_torch.harness.burst import make_burst_pods
from kubernetes_tpu_torch.harness.rest_perf import _main_hidden

UPGRADE_SCENARIOS = ("partitions-first", "schedulers-first",
                     "sigkill-partitions-first",
                     "sigkill-schedulers-first")

UPGRADE_QPS = 5000.0
FREEZE_BUDGET_S = 2.0
P99_ARRIVAL_TO_BIND_BUDGET_MS = 500.0

POD_CPU_MILLI = 100
POD_MEMORY = "50Mi"

SCHEDULER_TOKEN = "upgrade-scheduler-token"
CREATOR_TOKEN = "upgrade-creator-token"


def build_upgrade_trace(seed: int, pods: int, qps: float = UPGRADE_QPS,
                        namespaces: int = 16):
    """Open-loop steady arrivals like the sustained row's trace, but
    fanned across ``namespaces`` tenants round-robin — a single
    namespace is a single hash slot, which would park every pod on one
    partition and the roll would never cross a seam under load."""
    from dataclasses import replace

    from kubernetes_tpu_torch.workloads.trace import generate_trace

    trace = generate_trace(
        seed, pods, pods / qps, family="upgrade",
        name_prefix="up-", cpu_alpha=1.8, cpu_lo=100, cpu_hi=500,
        lifetime_modes=None, burst_factor=1.0, burst_period_s=0.0,
    )
    spread = [f"up-{i}" for i in range(namespaces)]
    trace.events[:] = [
        replace(e, namespace=spread[i % len(spread)])
        for i, e in enumerate(trace.events)]
    return trace


# ---------------------------------------------------------------------------
# spawned partition fleet (real processes, synchronous WAL, standbys)


def _upgrade_apiserver_main(conn, index: int, count: int, wal_dir: str,
                            restore: bool, hold: bool) -> None:
    """Partition server child. ``hold=True`` is the pre-spawned
    standby: imports are paid up front, then the child WAITS — the WAL
    restore must not start while the incumbent still appends. The
    parent's "serve" begins restore+serve; "abort" exits unused."""
    from kubernetes_tpu_torch.apiserver.rbac import provision_bootstrap_policy
    from kubernetes_tpu_torch.apiserver.rest import APIServer
    from kubernetes_tpu_torch.apiserver.store import ClusterStore
    from kubernetes_tpu_torch.apiserver.wal import attach_wal, restore_store
    from kubernetes_tpu_torch.utils.gctune import tune_for_throughput

    tune_for_throughput()
    if hold:
        # imports above are the expensive part of a spawn — pay them
        # BEFORE the roll needs this process, ack readiness, then wait
        conn.send("ready")
        if conn.recv() != "serve":
            return
    store = ClusterStore()
    if restore:
        restore_store(wal_dir, store)
    wal = attach_wal(store, wal_dir, snapshot_every=100_000,
                     async_serialize=False)
    authz = provision_bootstrap_policy(store)
    authz.add_user_to_group("upgrade-creator", "system:masters")
    tokens = {SCHEDULER_TOKEN: "system:kube-scheduler",
              CREATOR_TOKEN: "upgrade-creator"}
    server = APIServer(store=store, authorizer=authz, tokens=tokens,
                       partition=(index, count)).start()
    conn.send(server.url)
    while True:
        msg = conn.recv()
        if msg == "stop":
            break
        if msg == "drops":
            conn.send(server.watch_drops)
        elif msg == "quiesce":
            # drain endgame: compact to a snapshot and detach the WAL
            # while the server KEEPS SERVING reads/watches — writes are
            # frozen, so the log is quiet; the standby can now restore
            # this directory (one snapshot load, not a replay) while
            # this process still answers the fleet
            if wal is not None:
                wal.snapshot()
                wal.close()
                wal = None
            conn.send("quiesced")
        elif msg == "counts":
            import sys

            from kubernetes_tpu_torch.apiserver import codec

            pods = [(p.namespace, p.metadata.name,
                     p.metadata.resource_version,
                     bool(p.spec.node_name))
                    for p in store.list_pods()]
            conn.send({
                "partition": index,
                "pods": pods,
                "nodes": len(store.list_nodes()),
                "codec_version": codec.CODEC_VERSION,
                "epoch": server.partition_topology.epoch
                if server.partition_topology is not None else 0,
                "import_torch": "torch" in sys.modules,
                "watch_drops": server.watch_drops,
            })
    server.shutdown_server()
    if wal is not None:
        wal.close()
    conn.send("stopped")


class _SpawnedFleet:
    """The partition processes and their paused standbys."""

    def __init__(self, count: int, progress: Optional[Callable] = None):
        import multiprocessing as mp

        self.count = count
        self.progress = progress
        self.ctx = mp.get_context("spawn")
        self.wal_root = tempfile.mkdtemp(prefix="ktpu-upgrade-wal-")
        self.children: List[list] = []   # [conn, proc] — per partition
        self.standbys: Dict[int, list] = {}
        self.urls: List[str] = []
        self.restarts = [0] * count
        # slow watchers the retired processes dropped
        self.retired_watch_drops = 0

    def _spawn(self, i: int, restore: bool, hold: bool) -> list:
        seg = os.path.join(self.wal_root, f"p{i}")
        os.makedirs(seg, exist_ok=True)
        parent_conn, child_conn = self.ctx.Pipe()
        proc = self.ctx.Process(
            target=_upgrade_apiserver_main,
            args=(child_conn, i, self.count, seg, restore, hold),
            daemon=True)
        with _main_hidden():
            proc.start()
        return [parent_conn, proc]

    def start(self) -> List[str]:
        self.children = [self._spawn(i, restore=False, hold=False)
                         for i in range(self.count)]
        self.urls = [conn.recv() for conn, _ in self.children]
        return self.urls

    def prespawn_standbys(self, timeout: float = 60.0) -> None:
        for i in range(self.count):
            self.standbys[i] = self._spawn(i, restore=True, hold=True)
        # wait until every standby has paid its imports and is parked
        # at the serve gate — a not-yet-ready standby would put its
        # spawn cost back inside some partition's freeze window
        for i, (conn, _proc) in self.standbys.items():
            if conn.poll(timeout):
                conn.recv()

    def quiesce(self, i: int) -> None:
        """Snapshot + detach the incumbent's WAL (it keeps serving
        reads; writes are frozen) so the standby's restore is one
        snapshot load off a dead log."""
        conn, _proc = self.children[i]
        conn.send("quiesce")
        if conn.poll(10.0):
            conn.recv()

    def kill(self, i: int) -> None:
        """SIGKILL the incumbent mid-drain — the chaos seam. The WAL
        tail may be torn; the standby's restore must absorb it."""
        _conn, proc = self.children[i]
        proc.kill()
        proc.join(timeout=5.0)

    def promote(self, i: int) -> Tuple[list, str]:
        """Un-pause the standby: it restores the (quiesced or torn)
        WAL directory and serves at a fresh URL. Returns the OLD child
        for ``retire`` — it keeps serving reads until the reroute has
        re-pointed every client."""
        standby = self.standbys.pop(i)
        standby[0].send("serve")
        new_url = standby[0].recv()
        old = self.children[i]
        self.children[i] = standby
        self.urls[i] = new_url
        self.restarts[i] += 1
        return old, new_url

    def retire(self, old: list, killed: bool = False) -> None:
        conn, proc = old
        if not killed and proc.is_alive():
            try:
                conn.send("drops")
                if conn.poll(5.0):
                    self.retired_watch_drops += conn.recv()
                conn.send("stop")
                if conn.poll(5.0):
                    conn.recv()
            except (BrokenPipeError, EOFError, OSError):
                pass
        proc.join(timeout=5.0)
        if proc.is_alive():
            proc.terminate()

    def counts(self) -> List[dict]:
        out = []
        for conn, _proc in self.children:
            conn.send("counts")
            out.append(conn.recv())
        return out

    def teardown(self) -> None:
        for extra in self.standbys.values():
            try:
                extra[0].send("abort")
            except (BrokenPipeError, OSError):
                pass
            extra[1].join(timeout=3.0)
            if extra[1].is_alive():
                extra[1].terminate()
        for conn, proc in self.children:
            try:
                conn.send("stop")
            except (BrokenPipeError, OSError):
                pass
        for conn, proc in self.children:
            try:
                if conn.poll(3.0):
                    conn.recv()
            except (EOFError, OSError):
                pass
            proc.join(timeout=3.0)
            if proc.is_alive():
                proc.terminate()
        shutil.rmtree(self.wal_root, ignore_errors=True)


# ---------------------------------------------------------------------------
# scheduler replica fleet (in-process brains over the REST fabric)


def _build_replica(index: int, count: int, client_factory,
                   use_batch: bool, max_batch: int, device,
                   commit_lock: threading.Lock):
    from kubernetes_tpu_torch.config.feature_gates import FeatureGates
    from kubernetes_tpu_torch.scheduler.replicas import (
        ReplicaSpec,
        install_replica_sharding,
    )
    from kubernetes_tpu_torch.scheduler.scheduler import Scheduler

    client = client_factory(index)
    sched = Scheduler.create(
        client,
        feature_gates=FeatureGates({"TPUBatchScheduler": use_batch}),
        provider="GangSchedulingProvider")
    # the capacity guard is on exactly when replicas share nodes
    install_replica_sharding(sched, ReplicaSpec(
        index=index, count=count, shard_pods=count > 1,
        shard_nodes=False))
    if sched.commit_capacity_guard \
            and getattr(client, "ledger", None) is None:
        # no bind-time ledger settles a node race: the fleet serializes
        # from the cache probe to the bind instead
        sched.commit_lock = commit_lock
    bs = None
    if use_batch:
        from kubernetes_tpu_torch.sidecar import attach_batch_scheduler

        bs = attach_batch_scheduler(sched, max_batch=max_batch,
                                    device=device)
    return sched, bs


class _ReplicaFleet:
    """M replica brains with a make-before-break roll: the replacement
    warms via ``start()`` (informer replay + queue shard) while the
    incumbent still binds — exactly the leader-election standby
    discipline — then the cut swaps the scheduling loop."""

    def __init__(self, client_factory, count: int,
                 use_batch: bool = True, max_batch: int = 4096,
                 progress: Optional[Callable] = None, device=None):
        self.client_factory = client_factory
        self.count = count
        self.use_batch = use_batch
        self.max_batch = max_batch
        self.progress = progress
        self.device = device
        self.commit_lock = threading.Lock()
        self.restarts = [0] * count
        # rolled-out replicas: a bind they started before the cut can
        # land after it, so their counts are read when asked for
        self.retired: list = []
        self.replicas = []
        self.batch_schedulers = []
        self._standbys: Dict[int, tuple] = {}
        for j in range(count):
            sched, bs = _build_replica(j, count, client_factory,
                                       use_batch, max_batch, device,
                                       self.commit_lock)
            self.replicas.append(sched)
            self.batch_schedulers.append(bs)

    def prepare_standbys(self, warm_pods=None) -> None:
        """Build, warm, and SYNC every successor BEFORE the open-loop
        clock starts — the replica half of the prespawned-standby
        discipline. A ``Scheduler.create`` + solver warmup + informer
        list mid-roll monopolizes the interpreter for seconds on a
        small host, and the incumbent's binding loop starving for that
        long reads as a roll-seam latency spike. Successors built here
        run informers (cache + queue shard track the cluster live, the
        hot-standby posture of leader election) but NO binding loop
        until ``roll`` promotes them; their queues self-clean as the
        incumbent's binds land as pod updates."""
        for j in range(self.count):
            if j in self._standbys:
                continue
            new, nbs = _build_replica(j, self.count,
                                      self.client_factory,
                                      self.use_batch, self.max_batch,
                                      self.device, self.commit_lock)
            if nbs is not None and warm_pods:
                nbs.warmup(warm_pods)
            new.start()
            self._standbys[j] = (new, nbs)

    def run(self) -> None:
        for sched in self.replicas:
            sched.run()

    def warmup(self, sample_pods) -> None:
        for bs in self.batch_schedulers:
            if bs is not None and sample_pods:
                bs.warmup(sample_pods)

    def _bound_of(self, sched) -> int:
        return sched.metrics.e2e_scheduling_duration.count("scheduled")

    def bound_count(self) -> int:
        return sum(self._bound_of(s) for s in self.retired + self.replicas)

    def pending_count(self) -> int:
        return sum(s.queue.pending_active_count() for s in self.replicas)

    def cache_nodes(self) -> List[int]:
        return [s.cache.node_count() for s in self.replicas]

    def roll(self, j: int, warm_pods=None,
             warm_timeout: float = 60.0) -> dict:
        t0 = time.monotonic()
        if j in self._standbys:
            # hot standby: informers already live, cache already warm
            new, nbs = self._standbys.pop(j)
        else:
            new, nbs = _build_replica(j, self.count,
                                      self.client_factory,
                                      self.use_batch, self.max_batch,
                                      self.device, self.commit_lock)
            if nbs is not None and warm_pods:
                nbs.warmup(warm_pods)
            # standby warm-up: informers + queue shard replay, NO
            # binding
            new.start()
        old = self.replicas[j]
        deadline = time.monotonic() + warm_timeout
        want = old.cache.node_count()
        while time.monotonic() < deadline \
                and new.cache.node_count() < want:
            time.sleep(0.05)
        # cut, make-before-break: the NEW loop starts binding while
        # the old one still runs — the shard never goes dark. The brief
        # overlap is the replica race the fleet already resolves: the
        # store's bind check and the capacity guard pick one winner, the
        # loser unwinds through unreserve/forget/requeue
        self.replicas[j] = new
        self.batch_schedulers[j] = nbs
        new._start_loop(f"schedule-rolled-{j}")
        old.stop()
        try:
            old.wait_for_inflight_bindings(timeout=10.0)
        except Exception:  # noqa: BLE001 — unwound via requeue
            pass
        self.retired.append(old)
        old.client._stop_watches()
        old.client._drop_conn()
        self.restarts[j] += 1
        handoff_ms = (time.monotonic() - t0) * 1000.0
        if self.progress:
            self.progress(f"upgrade: replica {j} rolled "
                          f"({handoff_ms:.0f}ms handoff)")
        return {"replica": j, "handoff_ms": round(handoff_ms, 1)}

    def flush(self, timeout: float = 30.0) -> None:
        for sched, bs in zip(self.replicas, self.batch_schedulers):
            if bs is not None:
                bs.flush(timeout=timeout)
            sched.wait_for_inflight_bindings(timeout=timeout)

    def stop(self) -> None:
        for new, _nbs in self._standbys.values():
            try:
                new.client._stop_watches()
                new.client._drop_conn()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        self._standbys.clear()
        for sched in self.replicas:
            sched.stop()
            try:
                sched.client._stop_watches()
                sched.client._drop_conn()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass


# ---------------------------------------------------------------------------
# the roll itself


def _roll_one_partition(fleet: _SpawnedFleet, coordinator, i: int,
                        budget_s: float, kill: bool,
                        progress: Optional[Callable]) -> dict:
    """Freeze → drain → verify → cut → reroute for one partition.
    Returns the per-partition record (frozen_ms, aborts, killed)."""
    from kubernetes_tpu_torch.apiserver.reshard import ReshardError

    rec = {"partition": i, "aborts": 0, "killed": bool(kill),
           "rolled": False, "frozen_ms": 0.0,
           "freeze_budget_ms": budget_s * 1000.0}
    eta = budget_s
    for attempt in range(2):
        t0 = time.monotonic()
        topo = coordinator.fetch_topology()
        slots = topo.slots_of_partition(i)
        if slots:
            try:
                # answers once the writes let through before the freeze
                # are in the synchronous WAL
                coordinator._freeze({i: slots}, eta)
                coordinator._verify_frozen({i: slots})
            except ReshardError:
                # the drain outlived its freeze budget: ABORT — thaw,
                # the incumbent keeps serving, retry with 2× budget
                coordinator._unfreeze({i: slots})
                rec["aborts"] += 1
                eta *= 2.0
                continue
        if kill:
            # the chaos seam: SIGKILL the process CURRENTLY DRAINING —
            # no quiesce, the standby restores a possibly-torn tail
            fleet.kill(i)
        else:
            fleet.quiesce(i)
        old, new_url = fleet.promote(i)
        reroute = coordinator.reroute_after_restart(i, new_url)
        # the write-frozen window ends here: the new process serves
        # unfrozen and every client has been re-pointed
        rec["frozen_ms"] = round((time.monotonic() - t0) * 1000.0, 1)
        rec["rolled"] = True
        # first-class seam span into the fleet timeline: a sampled pod
        # whose queue.wait overlaps this roll window names the roll in
        # its critical path instead of unattributed stall
        try:
            from kubernetes_tpu_torch.observability import get_tracer

            get_tracer().record(
                "upgrade.roll", t0,
                trace=f"seam:{reroute.get('epoch', 0)}",
                partition=i, killed=bool(kill),
                frozen_ms=rec["frozen_ms"])
        except Exception:  # noqa: BLE001 — tracing must not fail a roll
            pass
        if not kill:
            # grace before retiring the read-only incumbent: let every
            # client's topology poll observe the new epoch and replumb
            # its streams, so the old process dies with no stream on it
            time.sleep(0.5)
        fleet.retire(old, killed=kill)
        if progress:
            progress(f"upgrade: partition {i} rolled "
                     f"({'SIGKILL' if kill else 'drained'}, "
                     f"{rec['frozen_ms']:.0f}ms frozen) → {new_url}")
        return rec
    return rec


def _client_counters(clients) -> dict:
    relists = 0
    reneg = 0
    failures = 0
    rv_regressions = 0
    handoffs = 0
    for c in clients:
        relists += sum(c.stream_relists.values())
        reneg += c.codec_renegotiations
        failures += c.codec_failures
        rv_regressions += len(c.rv_regressions)
        handoffs += c.handoff_fetches
    return {"unmoved_relists": relists,
            "relists_by_client": [
                {f"{kind}/p{p}": n for (kind, p), n in
                 c.stream_relists.items()} for c in clients],
            "codec_renegotiations": reneg,
            "codec_failures": failures,
            "rv_regressions": rv_regressions,
            "handoff_fetches": handoffs}


def run_upgrade_roll(
    *,
    partitions: int = 3,
    replicas: int = 2,
    pods: int = 30_000,
    qps: float = UPGRADE_QPS,
    seed: int = 16,
    scenario: str = "partitions-first",
    node_cpu: int = 32,
    max_batch: int = 4096,
    use_batch: bool = True,
    freeze_budget_s: float = FREEZE_BUDGET_S,
    wait_timeout: float = 600.0,
    progress: Optional[Callable[[str], None]] = None,
    device=None,
) -> dict:
    """One full rolling upgrade under open-loop load, the replicas' batch
    paths on ``device`` (the card unless "cpu"). Returns the raw result
    surface; ``run_upgrade_row`` shapes the committed row and
    ``run_upgrade_cell`` the chaos verdict."""
    from kubernetes_tpu_torch.api.types import Node
    from kubernetes_tpu_torch.apiserver.partition import PartitionTopology
    from kubernetes_tpu_torch.apiserver.reshard import ReshardCoordinator
    from kubernetes_tpu_torch.device import resolve_device
    from kubernetes_tpu_torch.harness.chaos_reshard import _Recorder
    from kubernetes_tpu_torch.harness.perf import (
        attach_slo_baseline,
        collect_freshness,
        reset_sli_window,
    )
    from kubernetes_tpu_torch.harness.sustained import sustained_nodes
    from kubernetes_tpu_torch.observability.devprof import get_devprof
    from kubernetes_tpu_torch.utils.gctune import tune_for_throughput
    from kubernetes_tpu_torch.workloads.replay import ReplayEngine
    from kubernetes_tpu_torch.workloads.trace import events_to_pods

    if scenario not in UPGRADE_SCENARIOS:
        raise ValueError(f"unknown upgrade scenario {scenario!r} "
                         f"(have: {', '.join(UPGRADE_SCENARIOS)})")
    dev = resolve_device(device) if use_batch else None
    tune_for_throughput()
    reset_sli_window()
    get_devprof().reset(workload=f"upgrade/{scenario}")
    rng = random.Random(seed)
    trace = build_upgrade_trace(seed, pods, qps)
    node_dicts = sustained_nodes(trace, node_cpu=node_cpu)

    fleet = _SpawnedFleet(partitions, progress=progress)
    urls = fleet.start()
    clients: List[RestClusterClient] = []

    def make_client(token: str, watch_kinds=(), codec_version=None,
                    qps_limit=None) -> RestClusterClient:
        kw = {}
        if codec_version is not None:
            kw["codec_version"] = codec_version
        # max_retries=8: a seam (retire/SIGKILL → promote → reroute →
        # replumb) must fit inside one request's retry envelope — the
        # backoff re-resolves the pool each attempt, so the retries
        # follow the replumb onto the successor process
        c = RestClusterClient(urls[0], partition_urls=list(urls),
                              token=token, qps=qps_limit,
                              watch_kinds=watch_kinds, max_retries=8,
                              **kw)
        assert c.enable_topology(poll_interval=0.2)
        clients.append(c)
        return c

    rfleet = None
    engine = None
    try:
        control = RestClusterClient(urls[0], partition_urls=list(urls),
                                    token=CREATOR_TOKEN)
        clients.append(control)
        coordinator = ReshardCoordinator(control,
                                         freeze_eta=freeze_budget_s,
                                         evict_grace_s=0.05)
        topo = PartitionTopology.default(partitions, urls=urls)
        coordinator.install_topology(topo)
        assert control.enable_topology(poll_interval=0.2)

        nodes = [Node.from_dict(d) for d in node_dicts]
        for lo in range(0, len(nodes), 512):
            control.create_objects_bulk("Node", nodes[lo:lo + 512])
        if progress:
            progress(f"upgrade[{scenario}]: {len(nodes)} nodes across "
                     f"{partitions} partitions, {replicas} replicas, "
                     f"{len(trace.events)} arrivals @ {qps:.0f}/s")

        rfleet = _ReplicaFleet(
            lambda j: make_client(SCHEDULER_TOKEN,
                                  watch_kinds=("Pod", "Node")),
            count=replicas, use_batch=use_batch, max_batch=max_batch,
            progress=progress, device=dev)
        for sched in rfleet.replicas:
            attach_slo_baseline(sched)
        rfleet.run()
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            if min(rfleet.cache_nodes()) >= len(nodes):
                break
            time.sleep(0.1)
        samples = events_to_pods(trace.events[:128])
        rfleet.warmup(samples)
        if progress:
            progress(f"upgrade[{scenario}]: replica caches warm "
                     f"{rfleet.cache_nodes()}")

        # the OLD-VERSION witness: pinned to codec v1 for the whole
        # roll — its watch frames arrive in the legacy 3-tuple shape,
        # and every restart seam must still re-pin it explicitly
        recorder = _Recorder()
        v1_client = make_client(CREATOR_TOKEN, watch_kinds=("Pod",),
                                codec_version=1)
        v1_client.watch(recorder.on_events)

        engine_client = make_client(CREATOR_TOKEN,
                                    watch_kinds=("Pod",))
        engine = ReplayEngine(engine_client, trace, time_scale=1.0,
                              expire=False, progress=progress)

        # pay the standby spawns (process start + imports) BEFORE the
        # open-loop clock starts: a standby importing the world while
        # arrivals stream steals exactly the CPU the injector and
        # binders need, and the backlog it causes reads as roll-seam
        # latency. The standbys hold pre-restore, so spawning early
        # cannot observe a stale WAL — restore begins at "serve".
        # Same discipline for the replica successors: build + solver
        # warmup up front, promote-only at roll time.
        fleet.prespawn_standbys()
        rfleet.prepare_standbys(warm_pods=samples)

        t_start = time.monotonic()
        engine.start()
        time.sleep(max(0.5, 0.05 * len(trace.events) / max(qps, 1.0)))

        # ---- the roll --------------------------------------------------
        kill_victim = (rng.randrange(partitions)
                       if scenario.startswith("sigkill-") else None)
        part_order = list(range(partitions))
        part_records: List[dict] = []
        replica_records: List[dict] = []

        def roll_partitions() -> None:
            for i in part_order:
                part_records.append(_roll_one_partition(
                    fleet, coordinator, i, freeze_budget_s,
                    kill=(i == kill_victim), progress=progress))

        def roll_replicas() -> None:
            for j in range(replicas):
                replica_records.append(rfleet.roll(j, warm_pods=samples))
                attach_slo_baseline(rfleet.replicas[j])

        if scenario.endswith("schedulers-first"):
            roll_replicas()
            roll_partitions()
        else:
            roll_partitions()
            roll_replicas()
        roll_wall_s = time.monotonic() - t_start

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
                progress(f"upgrade[{scenario}]: {bound}/{want} bound")
            time.sleep(0.1)
        rfleet.flush()
        stats = engine.finish()
        engine = None
        time.sleep(0.5)   # quiesce: streams catch up before the audit

        # ---- invariants ------------------------------------------------
        union: Dict[tuple, str] = {}
        dups = 0
        bound_truth = 0
        epochs = set()
        children_torch = False
        watch_drops = fleet.retired_watch_drops
        for counts in fleet.counts():
            epochs.add(counts["epoch"])
            children_torch |= counts["import_torch"]
            watch_drops += counts["watch_drops"]
            for ns, name, rv, is_bound in counts["pods"]:
                key = (ns, name)
                if key in union:
                    dups += 1
                union[key] = rv
                if is_bound:
                    bound_truth += 1
        rec_missing = [k for k in union if k not in recorder.state]
        rec_extra = [k for k in recorder.state if k not in union]
        rec_stale = [k for k, rv in union.items()
                     if recorder.state.get(k) not in (None, rv)]
        doubles = recorder.doubles()
        counters = _client_counters(clients)
        fresh = collect_freshness(
            get_devprof().summary() if get_devprof().enabled else None)
        slo = (fresh or {}).get("slo") or {}
        frozen_ms_max = max(
            (r["frozen_ms"] for r in part_records), default=0.0)
        rolled_ok = (
            all(r["rolled"] for r in part_records)
            and list(fleet.restarts) == [1] * partitions
            and list(rfleet.restarts) == [1] * replicas)
        v1_pins = dict(v1_client.negotiated_codec)
        result = {
            "scenario": scenario,
            "seed": seed,
            "device": str(dev) if dev is not None else "host",
            "partitions": partitions,
            "replicas": replicas,
            "qps": qps,
            "injected": stats.injected,
            "ever_bound": stats.ever_bound,
            "server_pods": len(union),
            "server_bound": bound_truth,
            "lost_pods": stats.lost,
            "send_errors": list(stats.send_errors),
            "p99_arrival_to_bind_ms": round(stats.latency_p99_ms()),
            "p50_arrival_to_bind_ms": round(
                stats.arrival_to_bind.get("all", {}).get("p50", 0.0)
                * 1000),
            "duplicates": dups,
            "doubles": len(doubles),
            "lost_watches": (len(rec_missing) + len(rec_extra)
                             + len(rec_stale)),
            "rolled_partitions": sum(
                1 for r in part_records if r["rolled"]),
            "rolled_replicas": len(replica_records),
            "partition_restarts": list(fleet.restarts),
            "replica_restarts": list(rfleet.restarts),
            "rolled_exactly_once": rolled_ok,
            "aborts": sum(r["aborts"] for r in part_records),
            "kill_victim": kill_victim,
            "frozen_ms_max": frozen_ms_max,
            "freeze_budget_ms": freeze_budget_s * 1000.0,
            "roll_wall_s": round(roll_wall_s, 2),
            "last_bind_s": round(stats.last_bind_s, 3),
            "epochs": sorted(epochs),
            "children_import_torch": children_torch,
            # slow watchers the partition processes dropped (their torn
            # streams relist)
            "watch_drops": watch_drops,
            "v1_negotiated": v1_pins,
            "v1_pin_ok": (all(v == 1 for v in v1_pins.values())
                          and len(v1_pins) == partitions),
            "partition_records": part_records,
            "replica_records": replica_records,
            "freshness": fresh,
            "slo_verdicts_ok": (all(v == "ok" for v in slo.values())
                                if slo else None),
        }
        result.update(counters)
        # ---- fleet trace: scrape every partition's /debug/trace with
        # half-RTT skew correction, absorb the in-parent ring (replica
        # schedulers + coordinator + replay engine all record there),
        # merge, and attribute the per-pod cross-process critical path
        try:
            from kubernetes_tpu_torch.observability import get_tracer
            from kubernetes_tpu_torch.observability.fleettrace import (
                collect_fleet_trace,
            )

            doc, cp = collect_fleet_trace(
                remote=[(f"apiserver-{i}", u)
                        for i, u in enumerate(fleet.urls)],
                local=[("scheduler", get_tracer())],
                token=SCHEDULER_TOKEN, max_pods=25)
            result["fleet_trace_doc"] = doc
            result["critical_path"] = cp
        except Exception:  # noqa: BLE001 — tracing must not fail a row
            pass
        return result
    finally:
        if engine is not None:
            try:
                engine.finish()
            except Exception:  # noqa: BLE001 — teardown must not mask
                pass
        if rfleet is not None:
            rfleet.stop()
        for c in clients:
            try:
                c._stop_watches()
                c._drop_conn()
            except Exception:  # noqa: BLE001
                pass
        fleet.teardown()
        import gc

        gc.collect()


# ---------------------------------------------------------------------------
# the committed row + diag


def _upgrade_ok(res: dict) -> Tuple[bool, str]:
    checks = {
        "lost_pods": res["lost_pods"] == 0,
        "all_bound": res["ever_bound"] >= res["injected"] > 0,
        "send_errors": not res["send_errors"],
        "duplicates": res["duplicates"] == 0,
        "doubles": res["doubles"] == 0,
        "lost_watches": res["lost_watches"] == 0,
        "unmoved_relists": res["unmoved_relists"] == 0,
        "rv_regressions": res["rv_regressions"] == 0,
        "rolled_exactly_once": res["rolled_exactly_once"],
        "one_epoch": len(res["epochs"]) == 1,
        "freeze_budget": (res["frozen_ms_max"]
                          <= res["freeze_budget_ms"]),
        "codec_failures": res["codec_failures"] == 0,
        "v1_pin": res["v1_pin_ok"],
        "slo": res["slo_verdicts_ok"] is not False,
    }
    bad = [k for k, ok in checks.items() if not ok]
    return not bad, " ".join(bad)


def run_upgrade_row(
    pods: int = 2400,
    qps: float = 100.0,
    seed: int = 16,
    *,
    partitions: int = 3,
    replicas: int = 2,
    node_cpu: int = 32,
    max_batch: int = 256,
    freeze_budget_s: float = FREEZE_BUDGET_S,
    wait_timeout: float = 600.0,
    progress: Optional[Callable[[str], None]] = None,
    device=None,
) -> dict:
    """The rolling-upgrade row (the JAX package's ``bench.py --config
    upgrade``): full-fleet roll at open-loop arrival rate, headline =
    p99 arrival→bind with every robustness invariant as the verdict
    surface (``_upgrade_ok``); the replicas' batch paths on ``device``
    (the card unless "cpu").

    The defaults are sized to the END-TO-END REST budget of the bench
    host (every arrival is an HTTP create, every bind an HTTP POST,
    across 6+ real processes): the offered rate must be one the
    binding pipeline can actually absorb, or the open-loop backlog —
    not the roll — owns the p99 and the row measures the injector's
    queue instead of the seams. Scale ``qps``/``pods`` up on hardware
    with cores to spare; the invariants are rate-independent."""
    res = run_upgrade_roll(
        partitions=partitions, replicas=replicas, pods=pods, qps=qps,
        seed=seed, scenario="partitions-first", node_cpu=node_cpu,
        max_batch=max_batch, freeze_budget_s=freeze_budget_s,
        wait_timeout=wait_timeout, progress=progress, device=device)
    ok, why = _upgrade_ok(res)
    value = (res["ever_bound"] / res["roll_wall_s"]
             if res["roll_wall_s"] > 0 else 0.0)
    row = {
        "metric": (
            f"upgrade_roll[open-loop {qps:.0f}/s "
            f"{partitions}part+{replicas}sched rolling restart, "
            f"{pods}pods seed={seed}, REST fabric]"),
        "value": round(value, 1),
        "unit": "pods/s",
        "roll_wall_s": res["roll_wall_s"],
        "offered_rate_pods_per_sec": round(qps, 1),
        "p99_arrival_to_bind_ms": res["p99_arrival_to_bind_ms"],
        "p50_arrival_to_bind_ms": res["p50_arrival_to_bind_ms"],
        "injected": res["injected"],
        "ever_bound": res["ever_bound"],
        "lost_pods": res["lost_pods"],
        "lost_watch_events": res["lost_watches"],
        "duplicated_events": res["doubles"],
        "unmoved_relists": res["unmoved_relists"],
        "rolled_partitions": res["rolled_partitions"],
        "rolled_replicas": res["rolled_replicas"],
        "rolled_exactly_once": res["rolled_exactly_once"],
        "frozen_ms_max": res["frozen_ms_max"],
        "freeze_budget_ms": res["freeze_budget_ms"],
        "codec_renegotiations": res["codec_renegotiations"],
        "codec_failures": res["codec_failures"],
        "handoff_fetches": res["handoff_fetches"],
        "epoch": res["epochs"][-1] if res["epochs"] else 0,
        "device": res["device"],
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
        # phase shares / unattributed_share / max_skew_ms ride the row;
        # the merged Perfetto doc is written aside when the caller names a destination —
        # megabytes of spans don't belong in a bench row
        row["critical_path"] = {k: v for k, v in cp.items()
                                if k != "per_pod"}
        out = os.environ.get("KTPU_FLEET_TRACE_OUT")
        doc = res.get("fleet_trace_doc")
        if out and doc:
            try:
                with open(out, "w") as f:
                    json.dump(doc, f)
                row["fleet_trace"] = os.path.basename(out)
            except OSError:
                pass
    _upgrade_diag(res)
    if progress:
        progress(f"[upgrade] rolled {res['rolled_partitions']}p+"
                 f"{res['rolled_replicas']}s, p99 arrival→bind "
                 f"{res['p99_arrival_to_bind_ms']}ms, lost "
                 f"{res['lost_pods']}, reneg "
                 f"{res['codec_renegotiations']}, "
                 f"{'OK' if ok else 'FAILED: ' + why}")
    return row


def _upgrade_diag(res: dict) -> None:
    import sys

    from kubernetes_tpu_torch.harness import diagfmt

    seg = diagfmt.format_upgrade({
        "rolled": res["rolled_partitions"] + res["rolled_replicas"],
        "frozen_ms_max": res["frozen_ms_max"],
        "reneg": res["codec_renegotiations"],
        "lost": res["lost_pods"] + res["lost_watches"],
        "relists": res["unmoved_relists"],
    })
    if seg:
        print(diagfmt.format_diag([seg]), file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# chaos cells


def run_upgrade_cell(seed: int, nodes: int = 0, pods: int = 400,
                     wait_timeout: float = 240.0,
                     progress: Optional[Callable] = None,
                     scenario: str = "partitions-first",
                     device=None) -> Dict:
    """One seeded (scenario × seed) cell: a compressed full roll —
    2 spawned partitions + 1 replica at a few hundred pods — crossing
    roll order × mid-roll SIGKILL on the draining process. Asserts
    rollback-or-complete (every process restarted exactly once, or an
    honest recorded abort) and the zero-lost surface. The replica's
    batch path runs on ``device`` (the card unless "cpu")."""
    res = run_upgrade_roll(
        partitions=2, replicas=1, pods=pods, qps=max(100.0, pods / 4.0),
        seed=seed, scenario=scenario, node_cpu=16, max_batch=256,
        freeze_budget_s=FREEZE_BUDGET_S, wait_timeout=wait_timeout,
        progress=progress, device=device)
    ok, why = _upgrade_ok(res)
    if scenario.startswith("sigkill-"):
        ok = ok and res["kill_victim"] is not None
        if res["kill_victim"] is None:
            why = (why + " no_kill").strip()
    return {
        "seed": seed, "profile": scenario, "ok": ok,
        "failure": "" if ok else (
            f"{why} lost={res['lost_pods']} "
            f"dups={res['duplicates']} doubles={res['doubles']} "
            f"relists={res['unmoved_relists']} "
            f"restarts={res['partition_restarts']}"
            f"+{res['replica_restarts']} epochs={res['epochs']}"),
        "stats": {
            "injected": res["injected"],
            "ever_bound": res["ever_bound"],
            "rolled": (res["rolled_partitions"]
                       + res["rolled_replicas"]),
            "aborts": res["aborts"],
            "kill_victim": res["kill_victim"],
            "frozen_ms_max": res["frozen_ms_max"],
            "reneg": res["codec_renegotiations"],
            "p99_arrival_to_bind_ms": res["p99_arrival_to_bind_ms"],
            "epoch": res["epochs"][-1] if res["epochs"] else 0,
        },
    }


def run_chaos_upgrade(seed: int, nodes: int = 0, pods: int = 400,
                      wait_timeout: float = 240.0,
                      progress: Optional[Callable] = None,
                      scenario: str = "partitions-first",
                      device=None) -> Dict:
    """One (scenario, seed) cell."""
    if scenario not in UPGRADE_SCENARIOS:
        raise ValueError(f"unknown upgrade scenario {scenario!r} "
                         f"(have: {', '.join(UPGRADE_SCENARIOS)})")
    return run_upgrade_cell(seed, nodes=nodes, pods=pods,
                            wait_timeout=wait_timeout,
                            progress=progress, scenario=scenario,
                            device=device)


# ---------------------------------------------------------------------------
# the mini-cell


def run_upgrade_mini_cell(
    nodes: int = 200,
    pods: int = 160,
    partitions: int = 2,
    settle_s: float = 1.2,
    progress: Optional[Callable[[str], None]] = None,
    device=None,
) -> Dict:
    """CI-fast rolling upgrade: ``partitions`` in-process apiservers
    (restart seam modeled as a NEW server on the surviving store — the
    WAL-restored equivalence without spawn cost) + ONE scheduler
    replica, all rolled under a sustained writer, with one client
    pinned to the OLD codec stamp for the duration. Asserted by the
    caller: informer ≡ server truth at quiesce, 0 lost watches, 0
    relists of unmoved slices, the v1 pin honored across every seam.
    The replica's batch path runs on ``device`` (the card unless
    "cpu"); the JAX cell's replica schedules serially."""
    from kubernetes_tpu_torch.apiserver.partition import PartitionTopology
    from kubernetes_tpu_torch.apiserver.reshard import ReshardCoordinator
    from kubernetes_tpu_torch.apiserver.rest import APIServer
    from kubernetes_tpu_torch.apiserver.store import ClusterStore
    from kubernetes_tpu_torch.client.informers import SharedInformerFactory
    from kubernetes_tpu_torch.device import resolve_device
    from kubernetes_tpu_torch.kubemark import HollowFleet

    dev = resolve_device(device)
    servers = [APIServer(store=ClusterStore(),
                         partition=(i, partitions)).start()
               for i in range(partitions)]
    urls = [s.url for s in servers]
    topo = PartitionTopology.default(partitions, urls=urls)
    for s in servers:
        s.install_topology(topo)

    client = RestClusterClient(urls[0], partition_urls=urls,
                               watch_kinds=("Pod", "Node"))
    # the OLD-VERSION witness: informers ride this v1-pinned client
    # through every restart seam — legacy 3-tuple frames all the way
    v1_client = RestClusterClient(urls[0], partition_urls=urls,
                                  watch_kinds=("Pod", "Node"),
                                  codec_version=1)
    coordinator = ReshardCoordinator(client, freeze_eta=5.0,
                                     evict_grace_s=0.1)
    factory = None
    fleet = None
    rfleet = None
    part_records: List[dict] = []
    try:
        assert client.enable_topology(poll_interval=0.15)
        assert v1_client.enable_topology(poll_interval=0.15)
        factory = SharedInformerFactory(v1_client)
        pod_lister = factory.lister_for("Pod")
        node_lister = factory.lister_for("Node")
        fleet = HollowFleet(client, interval=30.0)
        fleet.register(nodes, cpu="16", chunk=256)
        fleet.start()
        factory.start()
        factory.wait_for_cache_sync()
        if progress:
            progress(f"upgrade mini-cell: {nodes} hollow nodes up")

        def sched_client(j: int) -> RestClusterClient:
            # evaluated at roll time too: the replacement replica's
            # client must dial the CURRENT fleet, not the pre-roll URLs
            live = [s.url for s in servers]
            c = RestClusterClient(live[0], partition_urls=live,
                                  watch_kinds=("Pod", "Node"))
            assert c.enable_topology(poll_interval=0.15)
            return c

        rfleet = _ReplicaFleet(sched_client, count=1, use_batch=True,
                               progress=progress, device=dev)
        rfleet.run()
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline \
                and min(rfleet.cache_nodes()) < nodes:
            time.sleep(0.05)

        namespaces = [f"upmc-{i}" for i in range(8)]
        stop = threading.Event()
        errors: List[str] = []
        confirmed = [0]

        def writer() -> None:
            i = 0
            while not stop.is_set() and confirmed[0] < pods:
                batch = make_burst_pods(
                    4, cpu_milli=POD_CPU_MILLI, memory=POD_MEMORY,
                    name_prefix="upmc-", uid_prefix="upmcu-",
                    offset=i, namespaces=namespaces)
                try:
                    confirmed[0] += client.create_objects_bulk(
                        "Pod", batch)
                except Exception as e:  # noqa: BLE001
                    errors.append(f"{type(e).__name__}: {e}")
                    return
                i += 4
                time.sleep(0.01)

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        time.sleep(0.3)

        # ---- roll every partition (in-proc make-before-break) ------
        from kubernetes_tpu_torch.apiserver.reshard import ReshardError

        for i in range(partitions):
            t0 = time.monotonic()
            live_topo = coordinator.fetch_topology()
            slots = live_topo.slots_of_partition(i)
            aborted = False
            if slots:
                coordinator._freeze({i: slots}, 5.0)
                time.sleep(0.1)
                try:
                    coordinator._verify_frozen({i: slots})
                except ReshardError:
                    coordinator._unfreeze({i: slots})
                    aborted = True
            if aborted:
                part_records.append({"partition": i, "rolled": False,
                                     "frozen_ms": 0.0})
                continue
            replacement = APIServer(store=servers[i].store,
                                    partition=(i, partitions)).start()
            old = servers[i]
            servers[i] = replacement
            coordinator.reroute_after_restart(i, replacement.url)
            # the old endpoint goes away as a restarted process's does: a
            # new connection to it is refused rather than left waiting
            old.shutdown_server()
            old.server_close()
            part_records.append({
                "partition": i, "rolled": True,
                "frozen_ms": round(
                    (time.monotonic() - t0) * 1000.0, 1)})
            if progress:
                progress(f"upgrade mini-cell: partition {i} rolled")

        # ---- roll the scheduler replica ----------------------------
        replica_record = rfleet.roll(0)

        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            if confirmed[0] >= pods \
                    and rfleet.bound_count() >= confirmed[0]:
                break
            time.sleep(0.1)
        stop.set()
        t.join(timeout=5.0)
        rfleet.flush(timeout=15.0)
        time.sleep(settle_s)   # quiesce: informer catches up

        union: Dict[tuple, str] = {}
        duplicates = 0
        bound = 0
        for s in servers:
            for p in s.store.list_pods():
                key = (p.namespace, p.metadata.name)
                if key in union:
                    duplicates += 1
                union[key] = p.metadata.resource_version
                if p.spec.node_name:
                    bound += 1
        inf = {(o.metadata.namespace, o.metadata.name):
               o.metadata.resource_version for o in pod_lister.list()}
        missing = [k for k in union if k not in inf]
        extra = [k for k in inf if k not in union]
        stale = [k for k in union if k in inf and inf[k] != union[k]]
        v1_pins = dict(v1_client.negotiated_codec)
        return {
            "errors": errors,
            "confirmed": confirmed[0],
            "server_pods": len(union),
            "server_bound": bound,
            "scheduled": rfleet.bound_count(),
            "duplicates": duplicates,
            "informer_pods": len(inf),
            "informer_nodes": len(node_lister.list()),
            "missing": missing[:5],
            "extra": extra[:5],
            "stale": stale[:5],
            "lost_watches": len(missing) + len(extra) + len(stale),
            "unmoved_relists": sum(client.stream_relists.values())
            + sum(v1_client.stream_relists.values()),
            "rv_regressions": (list(client.rv_regressions)
                               + list(v1_client.rv_regressions)),
            "partition_records": part_records,
            "replica_record": replica_record,
            "rolled_partitions": sum(
                1 for r in part_records if r["rolled"]),
            "rolled_replicas": rfleet.restarts[0],
            "frozen_ms_max": max(
                (r["frozen_ms"] for r in part_records), default=0.0),
            "v1_negotiated": v1_pins,
            "v1_pin_ok": (all(v == 1 for v in v1_pins.values())
                          and len(v1_pins) == partitions),
            "v1_renegotiations": v1_client.codec_renegotiations,
            "codec_failures": (client.codec_failures
                               + v1_client.codec_failures),
            "epoch": client.topology_epoch,
        }
    finally:
        if rfleet is not None:
            rfleet.stop()
        if factory is not None:
            factory.stop()
        if fleet is not None:
            fleet.stop()
        client._stop_watches()
        client._drop_conn()
        v1_client._stop_watches()
        v1_client._drop_conn()
        for s in servers:
            s.shutdown_server()
