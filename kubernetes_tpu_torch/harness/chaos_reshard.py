"""Seeded chaos cells for live partition resharding.

Three scenario families (``run_chaos_reshard(seed, scenario=)``); none
runs a scheduler, so none takes a ``device``:

- ``midstorm`` — slice migrations (move → split → move) run while
  seeded writer threads storm creates/status-writes/deletes through an
  elastic client. Invariants: zero lost pods, zero duplicated objects
  across partitions, NO double-delivered watch events ((type, key, rv)
  observed at most once by a raw recording watcher), recorder state ≡
  server truth at quiesce, one topology epoch fleet-wide.

- ``sigkill`` — a REAL partition server process is SIGKILLed at a
  seeded phase of a live migration (after the copy, or just before the
  flip; source or destination). The coordinator must ROLL BACK or
  COMPLETE — never leave a torn routing table. The corpse restarts
  from its WAL segment, ``reroute_after_restart`` re-points the
  topology, and clients ride their cursors through the gap. Invariants:
  every confirmed pod present exactly once, a single max epoch on
  every live server, zero duplicates.

- ``rebalance`` — the PartitionRebalancer under a hot-namespace storm:
  it must ACT (split the tenant), placement must actually spread, and
  the zero-loss/no-dup invariants hold throughout.

Cells are compressed (seconds each); the hotspot bench row is the
full-scale proof.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.harness.burst import make_burst_pods
from kubernetes_tpu_torch.harness.rest_perf import _main_hidden

RESHARD_SCENARIOS = ("midstorm", "sigkill", "rebalance")

POD_CPU_MILLI = 100
POD_MEMORY = "50Mi"

SCHEDULER_TOKEN = "reshard-scheduler-token"
CREATOR_TOKEN = "reshard-creator-token"


# ---------------------------------------------------------------------------
# shared plumbing


def _spin_inproc_servers(n: int):
    """In-process apiserver threads (real HTTP; loopback trust)."""
    from kubernetes_tpu_torch.apiserver.partition import PartitionTopology
    from kubernetes_tpu_torch.apiserver.rest import APIServer
    from kubernetes_tpu_torch.apiserver.store import ClusterStore

    servers = [APIServer(store=ClusterStore(), partition=(i, n)).start()
               for i in range(n)]
    urls = [s.url for s in servers]
    topo = PartitionTopology.default(n, urls=urls)
    for s in servers:
        s.install_topology(topo)
    return servers, urls


class _Recorder:
    """Raw watch consumer counting (type, key, rv) deliveries — the
    no-double-delivery invariant's witness — and folding them into a
    state map (the cache≡store check)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.seen: Dict[tuple, int] = {}
        self.state: Dict[tuple, str] = {}

    def on_events(self, events) -> None:
        with self.lock:
            for e in events:
                key = (getattr(e.obj.metadata, "namespace", ""),
                       e.obj.metadata.name)
                sig = (e.type, key, e.obj.metadata.resource_version)
                self.seen[sig] = self.seen.get(sig, 0) + 1
                if e.type == "DELETED":
                    self.state.pop(key, None)
                else:
                    self.state[key] = e.obj.metadata.resource_version

    def doubles(self) -> List[tuple]:
        with self.lock:
            return [s for s, n in self.seen.items() if n > 1]


def _server_union(servers) -> Tuple[Dict[tuple, str], int]:
    union: Dict[tuple, str] = {}
    dups = 0
    for s in servers:
        for p in s.store.list_pods():
            key = (p.namespace, p.metadata.name)
            if key in union:
                dups += 1
            union[key] = p.metadata.resource_version
    return union, dups


# ---------------------------------------------------------------------------
# midstorm: migrations under a seeded write/update/delete storm


def run_reshard_midstorm(seed: int, nodes: int = 20, pods: int = 120,
                         wait_timeout: float = 120.0,
                         progress: Optional[Callable] = None) -> Dict:
    from kubernetes_tpu_torch.apiserver.reshard import ReshardCoordinator
    from kubernetes_tpu_torch.client.restcluster import RestClusterClient

    rng = random.Random(seed)
    servers, urls = _spin_inproc_servers(3)
    writer_client = RestClusterClient(urls[0], partition_urls=urls,
                                      watch_kinds=("Pod",))
    watch_client = RestClusterClient(urls[0], partition_urls=urls,
                                     watch_kinds=("Pod",))
    recorder = _Recorder()
    stats = {"created": 0, "deleted": 0, "statuses": 0, "failures": 0}
    alive: Dict[tuple, bool] = {}
    alive_lock = threading.Lock()
    try:
        writer_client.enable_topology(poll_interval=0.1)
        watch_client.enable_topology(poll_interval=0.1)
        watch_client.watch(recorder.on_events)
        time.sleep(0.3)
        coordinator = ReshardCoordinator(writer_client, freeze_eta=5.0,
                                         evict_grace_s=0.05)
        namespaces = [f"storm-{i}" for i in range(10)]
        stop = threading.Event()
        errors: List[str] = []

        def writer(tid: int) -> None:
            wrng = random.Random(seed * 100 + tid)
            i = 0
            while not stop.is_set():
                op = wrng.random()
                try:
                    if op < 0.65 or stats["created"] < 10:
                        ns = wrng.choice(namespaces)
                        pod = make_burst_pods(
                            1, cpu_milli=POD_CPU_MILLI,
                            memory=POD_MEMORY,
                            name_prefix=f"st{tid}-",
                            uid_prefix=f"su{tid}-", offset=i,
                            namespaces=[ns])[0]
                        writer_client.create_object("Pod", pod)
                        with alive_lock:
                            alive[(ns, pod.metadata.name)] = True
                            stats["created"] += 1
                        i += 1
                    else:
                        with alive_lock:
                            keys = list(alive)
                        if not keys:
                            continue
                        key = wrng.choice(keys)
                        if op < 0.85:
                            writer_client.set_pod_phase(
                                key[0], key[1], "Running")
                            stats["statuses"] += 1
                        else:
                            writer_client.delete_pod(key[0], key[1])
                            with alive_lock:
                                alive.pop(key, None)
                                stats["deleted"] += 1
                except Exception as e:  # noqa: BLE001 — storms may
                    # race a delete; count, don't die
                    stats["failures"] += 1
                    errors.append(f"{type(e).__name__}: {e}")
                    if len(errors) > 50:
                        return
                time.sleep(0.002)

        threads = [threading.Thread(target=writer, args=(t,),
                                    daemon=True) for t in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.5)

        # three migrations mid-storm, seeded shapes
        topo = coordinator.fetch_topology()
        slots0 = topo.slots_of_partition(0)
        moved = rng.sample(slots0, min(8, len(slots0)))
        rep1 = coordinator.move_slots({s: 1 for s in moved})
        time.sleep(0.3)
        hot_ns = rng.choice(namespaces)
        rep2 = coordinator.spread_namespace(hot_ns)
        time.sleep(0.3)
        topo = coordinator.fetch_topology()
        slots1 = topo.slots_of_partition(1)
        back = rng.sample(slots1, min(6, len(slots1)))
        rep3 = coordinator.move_slots({s: 2 for s in back})
        time.sleep(0.5)
        stop.set()
        for t in threads:
            t.join(timeout=5.0)
        time.sleep(1.0)   # quiesce

        union, dups = _server_union(servers)
        with alive_lock:
            expected = dict(alive)
        missing = [k for k in expected if k not in union]
        unexpected = [k for k in union if k not in expected]
        # recorder ≡ store at quiesce
        rec_missing = [k for k in union if k not in recorder.state]
        rec_stale = [k for k, rv in union.items()
                     if recorder.state.get(k) not in (None, rv)]
        rec_extra = [k for k in recorder.state if k not in union]
        doubles = recorder.doubles()
        epochs = {s.partition_topology.epoch for s in servers
                  if s.partition_topology is not None}
        ok = (not missing and not unexpected and dups == 0
              and not doubles and not rec_missing and not rec_stale
              and not rec_extra and len(epochs) == 1
              and stats["failures"] == 0
              and writer_client.rv_regressions == [])
        return {
            "seed": seed, "profile": "midstorm", "ok": ok,
            "failure": "" if ok else (
                f"missing={len(missing)} unexpected={len(unexpected)} "
                f"dups={dups} doubles={len(doubles)} "
                f"rec_missing={len(rec_missing)} "
                f"rec_stale={len(rec_stale)} "
                f"rec_extra={len(rec_extra)} epochs={sorted(epochs)} "
                f"failures={stats['failures']} "
                f"errs={errors[:2]}"),
            "stats": {
                "created": stats["created"],
                "deleted": stats["deleted"],
                "statuses": stats["statuses"],
                "moved": (rep1["moved_objects"] + rep2["moved_objects"]
                          + rep3["moved_objects"]),
                "migrations": 3,
                "frozen_ms": round(rep1["frozen_ms"]
                                   + rep2["frozen_ms"]
                                   + rep3["frozen_ms"], 1),
                "lost": len(missing),
                "unmoved_relists": sum(
                    watch_client.stream_relists.values()),
                "epoch": max(epochs) if epochs else 0,
            },
        }
    finally:
        watch_client._stop_watches()
        writer_client._stop_watches()
        watch_client._drop_conn()
        writer_client._drop_conn()
        for s in servers:
            s.shutdown_server()


# ---------------------------------------------------------------------------
# sigkill: a partition process dies mid-migration (real processes + WAL)


def _chaos_apiserver_main(conn, index: int, count: int, wal_dir: str,
                          restore: bool) -> None:
    """Partition server child with SYNCHRONOUS WAL (a SIGKILL must not
    lose acknowledged writes) and restore support (the failover
    path)."""
    from kubernetes_tpu_torch.apiserver.rbac import provision_bootstrap_policy
    from kubernetes_tpu_torch.apiserver.rest import APIServer
    from kubernetes_tpu_torch.apiserver.store import ClusterStore
    from kubernetes_tpu_torch.apiserver.wal import attach_wal, restore_store
    from kubernetes_tpu_torch.utils.gctune import tune_for_throughput

    tune_for_throughput()
    store = ClusterStore()
    if restore:
        restore_store(wal_dir, store)
    wal = attach_wal(store, wal_dir, snapshot_every=100_000,
                     async_serialize=False)
    authz = provision_bootstrap_policy(store)
    authz.add_user_to_group("reshard-creator", "system:masters")
    tokens = {SCHEDULER_TOKEN: "system:kube-scheduler",
              CREATOR_TOKEN: "reshard-creator"}
    server = APIServer(store=store, authorizer=authz, tokens=tokens,
                       partition=(index, count)).start()
    conn.send(server.url)
    while True:
        msg = conn.recv()
        if msg == "stop":
            break
        if msg == "counts":
            pods = [(p.namespace, p.metadata.name,
                     p.metadata.resource_version)
                    for p in store.list_pods()]
            conn.send({
                "partition": index,
                "pods": pods,
                "epoch": server.partition_topology.epoch
                if server.partition_topology is not None else 0,
            })
    server.shutdown_server()
    wal.close()
    conn.send("stopped")


def run_reshard_sigkill(seed: int, nodes: int = 20, pods: int = 80,
                        wait_timeout: float = 180.0,
                        progress: Optional[Callable] = None) -> Dict:
    import multiprocessing as mp
    import tempfile

    from kubernetes_tpu_torch.apiserver.partition import PartitionTopology
    from kubernetes_tpu_torch.apiserver.reshard import (
        ReshardCoordinator,
        ReshardError,
    )
    from kubernetes_tpu_torch.client.restcluster import RestClusterClient

    rng = random.Random(seed)
    ctx = mp.get_context("spawn")
    wal_root = tempfile.mkdtemp(prefix="ktpu-reshard-chaos-")
    partitions = 3
    servers: List[list] = []   # [conn, proc] — mutated on restart
    urls: List[str] = []
    import os
    import shutil

    for i in range(partitions):
        seg = os.path.join(wal_root, f"p{i}")
        os.makedirs(seg, exist_ok=True)
        parent_conn, child_conn = ctx.Pipe()
        proc = ctx.Process(target=_chaos_apiserver_main,
                           args=(child_conn, i, partitions, seg, False),
                           daemon=True)
        with _main_hidden():
            proc.start()
        servers.append([parent_conn, proc])
        urls.append(parent_conn.recv())

    client = RestClusterClient(urls[0], partition_urls=urls,
                               token=CREATOR_TOKEN, qps=None,
                               watch_kinds=("Pod",))
    coordinator = ReshardCoordinator(client, freeze_eta=4.0,
                                     evict_grace_s=0.05)

    def teardown() -> None:
        for conn, proc in servers:
            try:
                conn.send("stop")
            except (BrokenPipeError, OSError):
                pass
        for conn, proc in servers:
            try:
                if conn.poll(2.0):
                    conn.recv()
            except (EOFError, OSError):
                pass
            proc.join(timeout=3.0)
            if proc.is_alive():
                proc.terminate()
        shutil.rmtree(wal_root, ignore_errors=True)

    try:
        topo = PartitionTopology.default(partitions, urls=urls)
        coordinator.install_topology(topo)
        client.enable_topology(poll_interval=0.2)

        namespaces = [f"sk-{i}" for i in range(8)]
        confirmed: Dict[tuple, bool] = {}
        conf_lock = threading.Lock()
        stop = threading.Event()

        def writer() -> None:
            i = 0
            while not stop.is_set():
                ns = namespaces[i % len(namespaces)]
                pod = make_burst_pods(
                    1, cpu_milli=POD_CPU_MILLI, memory=POD_MEMORY,
                    name_prefix="sk-", uid_prefix="sku-", offset=i,
                    namespaces=[ns])[0]
                deadline = time.monotonic() + 30.0
                while not stop.is_set() \
                        and time.monotonic() < deadline:
                    try:
                        client.create_object("Pod", pod)
                        break
                    except ValueError:
                        break   # 409: an earlier timed-out try landed
                    except Exception:  # noqa: BLE001 — dead shard:
                        time.sleep(0.1)   # retry until failover heals
                else:
                    return
                with conf_lock:
                    confirmed[(ns, pod.metadata.name)] = True
                i += 1
                time.sleep(0.01)

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        time.sleep(0.5)

        # seeded kill plan: which party dies, at which phase
        kill_dest = rng.random() < 0.5
        phase = rng.choice(["copied", "pre_flip"])
        topo = coordinator.fetch_topology()
        src, dest = 0, 1
        moving = rng.sample(topo.slots_of_partition(src),
                            min(6, len(topo.slots_of_partition(src))))
        victim = dest if kill_dest else src
        killed = {"done": False}

        def kill_hook(at: str) -> None:
            if at == phase and not killed["done"]:
                killed["done"] = True
                servers[victim][1].kill()
                servers[victim][1].join(timeout=3.0)
                if progress:
                    progress(f"sigkill: killed partition {victim} "
                             f"at {at}")

        outcome = "completed"
        try:
            coordinator.move_slots({s: dest for s in moving},
                                   kill_hook=kill_hook)
        except ReshardError as e:
            outcome = "committed-then-resolved" \
                if getattr(e, "committed", False) else "rolled-back"
        except Exception as e:  # noqa: BLE001
            outcome = f"rolled-back({type(e).__name__})"
        if progress:
            progress(f"sigkill: migration {outcome}")

        # failover: restart the corpse from its WAL at a fresh URL
        seg = os.path.join(wal_root, f"p{victim}")
        parent_conn, child_conn = ctx.Pipe()
        proc = ctx.Process(target=_chaos_apiserver_main,
                           args=(child_conn, victim, partitions, seg,
                                 True),
                           daemon=True)
        with _main_hidden():
            proc.start()
        servers[victim] = [parent_conn, proc]
        new_url = parent_conn.recv()
        coordinator.reroute_after_restart(victim, new_url)
        if progress:
            progress(f"sigkill: partition {victim} restored at "
                     f"{new_url}")
        time.sleep(1.0)   # writes resume through the healed fleet
        stop.set()
        t.join(timeout=10.0)
        time.sleep(0.5)

        # -- invariants (per-server truth over the pipe) --------------
        union: Dict[tuple, str] = {}
        dups = 0
        epochs = set()
        for conn, _proc in servers:
            conn.send("counts")
            counts = conn.recv()
            epochs.add(counts["epoch"])
            for ns, name, rv in counts["pods"]:
                key = (ns, name)
                if key in union:
                    dups += 1
                union[key] = rv
        with conf_lock:
            expected = dict(confirmed)
        missing = [k for k in expected if k not in union]
        ok = (not missing and dups == 0 and len(epochs) == 1
              and killed["done"])
        return {
            "seed": seed, "profile": f"sigkill-{phase}",
            "ok": ok,
            "failure": "" if ok else (
                f"missing={len(missing)} dups={dups} "
                f"epochs={sorted(epochs)} outcome={outcome} "
                f"killed={killed['done']}"),
            "stats": {
                "confirmed": len(expected),
                "server_pods": len(union),
                "outcome": outcome,
                "victim": victim,
                "kill_phase": phase,
                "epoch": sorted(epochs)[-1] if epochs else 0,
                "lost": len(missing),
                "frozen_ms": round(sum(r["frozen_ms"]
                                       for r in coordinator.reports
                                       if "frozen_ms" in r), 1),
            },
        }
    finally:
        client._stop_watches()
        client._drop_conn()
        teardown()


# ---------------------------------------------------------------------------
# rebalance under storm: the controller must act, correctly


def run_reshard_rebalance(seed: int, nodes: int = 20, pods: int = 300,
                          wait_timeout: float = 120.0,
                          progress: Optional[Callable] = None) -> Dict:
    from kubernetes_tpu_torch.apiserver.reshard import ReshardCoordinator
    from kubernetes_tpu_torch.autoscaler.partitions import (
        PartitionGroup,
        PartitionRebalancer,
        RebalancePolicy,
        RestElasticDriver,
    )
    from kubernetes_tpu_torch.client.restcluster import RestClusterClient

    rng = random.Random(seed)
    servers, urls = _spin_inproc_servers(3)
    client = RestClusterClient(urls[0], partition_urls=urls,
                               watch_kinds=("Pod",))
    recorder = _Recorder()
    rebalancer = None
    try:
        client.enable_topology(poll_interval=0.1)
        client.watch(recorder.on_events)
        time.sleep(0.2)
        coordinator = ReshardCoordinator(client, freeze_eta=4.0,
                                         evict_grace_s=0.05)
        # in-proc servers share this process's registry: folding it
        # into itself would compound counters (see RestElasticDriver)
        driver = RestElasticDriver(coordinator, federate=False)
        # the fleet is pinned at 3 partitions: the cell's subject is
        # the SPLIT decision, so idle-retire and buy are fenced off
        rebalancer = PartitionRebalancer(
            driver, group=PartitionGroup(min_partitions=3,
                                         max_partitions=3,
                                         cooldown_s=0.5),
            policy=RebalancePolicy(min_rate=10.0, sustain_ticks=2),
            interval_s=0.25)
        rebalancer.run()

        hot_ns = "hot-tenant"
        cold = [f"cold-{i}" for i in range(6)]
        confirmed = [0]
        conf_lock = threading.Lock()
        stop = threading.Event()
        errors: List[str] = []

        def writer(tid: int) -> None:
            # storms until told to stop — ``pods`` is the FLOOR the
            # quiesce waits for, not a cap: the rebalancer needs a
            # sustained hot signal across several observation ticks
            wrng = random.Random(seed * 31 + tid)
            i = 0
            while not stop.is_set():
                ns = hot_ns if wrng.random() < 0.8 \
                    else wrng.choice(cold)
                batch = make_burst_pods(
                    4, cpu_milli=POD_CPU_MILLI, memory=POD_MEMORY,
                    name_prefix=f"rb{tid}-", uid_prefix=f"rbu{tid}-",
                    offset=i, namespaces=[ns])
                try:
                    got = client.create_objects_bulk("Pod", batch)
                except Exception as e:  # noqa: BLE001
                    errors.append(f"{type(e).__name__}: {e}")
                    return
                with conf_lock:
                    confirmed[0] += got
                i += 4
                time.sleep(0.005)

        threads = [threading.Thread(target=writer, args=(t,),
                                    daemon=True) for t in range(2)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + wait_timeout
        while time.monotonic() < deadline:
            with conf_lock:
                made = confirmed[0]
            if rebalancer.actions and made >= pods:
                break
            time.sleep(0.1)
        stop.set()
        for t in threads:
            t.join(timeout=5.0)
        if rebalancer is not None:
            rebalancer.stop()
        time.sleep(1.0)

        union, dups = _server_union(servers)
        acted = [a["action"]["op"] for a in rebalancer.actions]
        # placement actually spread: the hot namespace's pods land on
        # more than one partition once the split committed
        hot_parts = {
            i for i, s in enumerate(servers)
            if any(p.namespace == hot_ns for p in s.store.list_pods())}
        doubles = recorder.doubles()
        ok = (len(union) == confirmed[0] and dups == 0
              and not errors and not doubles
              and "split" in acted and len(hot_parts) > 1)
        return {
            "seed": seed, "profile": "rebalance", "ok": ok,
            "failure": "" if ok else (
                f"union={len(union)} confirmed={confirmed[0]} "
                f"dups={dups} doubles={len(doubles)} acted={acted} "
                f"hot_parts={sorted(hot_parts)} errs={errors[:2]}"),
            "stats": {
                "created": confirmed[0],
                "actions": acted,
                "hot_partitions": len(hot_parts),
                "epoch": client.topology_epoch,
                "lost": max(0, confirmed[0] - len(union)),
                "unmoved_relists": sum(client.stream_relists.values()),
                "frozen_ms": round(sum(
                    (a.get("report") or {}).get("frozen_ms", 0.0)
                    for a in rebalancer.actions), 1),
            },
        }
    finally:
        if rebalancer is not None:
            rebalancer.stop()
        client._stop_watches()
        client._drop_conn()
        for s in servers:
            s.shutdown_server()


def run_chaos_reshard(seed: int, nodes: int = 20, pods: int = 120,
                      wait_timeout: float = 180.0,
                      progress: Optional[Callable] = None,
                      scenario: str = "midstorm") -> Dict:
    """One (scenario, seed) cell."""
    if scenario == "midstorm":
        return run_reshard_midstorm(seed, nodes=nodes, pods=pods,
                                    wait_timeout=wait_timeout,
                                    progress=progress)
    if scenario == "sigkill":
        return run_reshard_sigkill(seed, nodes=nodes, pods=pods,
                                   wait_timeout=wait_timeout,
                                   progress=progress)
    if scenario == "rebalance":
        return run_reshard_rebalance(seed, nodes=nodes, pods=pods,
                                     wait_timeout=wait_timeout,
                                     progress=progress)
    raise ValueError(f"unknown reshard scenario {scenario!r} "
                     f"(have: {', '.join(RESHARD_SCENARIOS)})")
