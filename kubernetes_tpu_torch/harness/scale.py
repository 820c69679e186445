"""The scale row: the partitioned control plane under a hollow fleet.

The deployment shape: P apiserver processes (one store partition each,
each with its own interpreter), a kubemark ``HollowFleet`` registering
its nodes in bulk and renewing their leases over the fabric, the same
child creating pods across namespaces (pods shard by namespace, so the
burst spreads over the partitions), and M scheduler replicas in this
process (pod-hash queues, disjoint node pools by default), each with its
own partition-aware client merging one watch stream a (kind, partition)
and its own batch path on the card.

``run_scale10x_row`` (``bench.py --config scale10x``) runs two REST arms
at one size, partitions=P and partitions=1 (the A/B that says whether
sharding pays), and the in-process conflict cell (replicas racing on
every pod over shared nodes, the partitioned store's bind-time ledger
arbitrating). It reports:

- pods/s of each arm, the e2e histogram's p50 and p99, and the speedup;
- invariants from each partition server's own counts: zero lost pods,
  zero double binds (no pod held twice, no node over its allocatable
  CPU), and in the conflict cell conflicts that happened and were all
  resolved;
- the observability wire-up: every partition server and replica
  registry in the metrics federation (at least partitions + replicas
  instances), the SLO verdicts, and a ``shards[...]`` diag segment;
- the stale binds refused by path, the partition balance, the number of
  watch streams, the replicas' node pools, and the card's busy share
  (the device profiler's seconds over the window).

The child mains import no torch (``children_import_torch`` checks it):
the scheduler, and with it the card, runs only in this process.
"""

from __future__ import annotations

import multiprocessing as mp
import sys
import time
from typing import Callable, Dict, List, Optional

from kubernetes_tpu_torch.harness.burst import make_burst_pods, stream_arrivals
from kubernetes_tpu_torch.harness.rest_perf import CHILD_START_S, _main_hidden

SCHEDULER_TOKEN = "scale-scheduler-token"
CREATOR_TOKEN = "scale-creator-token"
KUBEMARK_TOKEN = "scale-kubemark-token"

POD_CPU_MILLI = 500
POD_MEMORY = "500Mi"
# partition-aware creator clients in the driver child, the burst's
# chunks rotated over them
CREATOR_CLIENTS = 4
# the scale row's conflict cell: four times ``run_conflict_cell``'s
# 10 nodes / 38 pods and as tight (95% of the CPU asked for). At 38 pods
# two replicas now and then never race (zero conflicts, and a cell with
# no conflict proves nothing); at 152 each run holds dozens of races
CONFLICT_NODES, CONFLICT_PODS = 40, 152


def scale_namespaces(partitions: int, per_partition: int = 2) -> List[str]:
    """Namespaces whose hashes cover every partition, ``per_partition``
    of them each (a burst in one namespace would land whole in one
    partition)."""
    if partitions <= 1:
        return ["default"]
    from kubernetes_tpu_torch.apiserver.partition import partition_for

    want = {p: per_partition for p in range(partitions)}
    out: List[str] = []
    i = 0
    while any(v > 0 for v in want.values()) and i < 10_000:
        ns = f"scale-{i}"
        p = partition_for("Pod", ns, None, partitions)
        if want.get(p, 0) > 0:
            want[p] -= 1
            out.append(ns)
        i += 1
    return out


# ---------------------------------------------------------------------------
# child mains (spawned; no torch)


def _scale_apiserver_main(conn, index: int, count: int) -> None:
    """Partition ``index`` of ``count``: a plain ClusterStore behind a
    full APIServer (tokens, RBAC, admission, APF, the watch cache)."""
    from kubernetes_tpu_torch.apiserver.rbac import provision_bootstrap_policy
    from kubernetes_tpu_torch.apiserver.rest import APIServer
    from kubernetes_tpu_torch.apiserver.store import ClusterStore
    from kubernetes_tpu_torch.utils.gctune import tune_for_throughput

    tune_for_throughput()
    store = ClusterStore()
    authz = provision_bootstrap_policy(store)
    authz.add_user_to_group("scale-creator", "system:masters")
    authz.add_user_to_group("scale-kubemark", "system:masters")
    tokens = {SCHEDULER_TOKEN: "system:kube-scheduler",
              CREATOR_TOKEN: "scale-creator",
              KUBEMARK_TOKEN: "scale-kubemark"}
    server = APIServer(store=store, authorizer=authz, tokens=tokens,
                       partition=(index, count)).start()
    conn.send(server.url)
    while True:
        msg = conn.recv()
        if msg == "stop":
            break
        if msg == "counts":
            # the invariants' inputs, computed here (shipping every pod
            # to the parent would dwarf the row): the CPU requested on
            # each node by the pods this partition holds, and the
            # allocatable CPU of the nodes it holds; the parent joins
            # them across partitions (a pod and its node usually live in
            # different partitions)
            pods = store.list_pods()
            node_req: Dict[str, int] = {}
            for p in pods:
                if p.spec.node_name:
                    node_req[p.spec.node_name] = node_req.get(
                        p.spec.node_name, 0) + POD_CPU_MILLI
            node_alloc: Dict[str, int] = {}
            for n in store.list_nodes():
                q = (n.status.allocatable or n.status.capacity or {}).get(
                    "cpu")
                node_alloc[n.name] = int(q.milli_value()) if q is not None \
                    else 1 << 62
            conn.send({
                "partition": index,
                "pods_total": len(pods),
                "pods_bound": sum(1 for p in pods if p.spec.node_name),
                "node_req": node_req,
                "node_alloc": node_alloc,
                "nodes": len(node_alloc),
                "import_torch": "torch" in sys.modules,
            })
    server.shutdown_server()
    conn.send("stopped")


def _scale_driver_main(conn, urls: List[str], qps: Optional[float]
                       ) -> None:
    """The kubemark and workload child: registers the hollow fleet
    (bulk NodeList posts split by partition, one heartbeat thread
    renewing leases) and streams pods through partition-aware creator
    clients."""
    from kubernetes_tpu_torch.client.restcluster import RestClusterClient
    from kubernetes_tpu_torch.kubemark import HollowFleet
    from kubernetes_tpu_torch.utils.gctune import tune_for_throughput

    tune_for_throughput()
    fleet_client = RestClusterClient(urls[0], partition_urls=urls,
                                     token=KUBEMARK_TOKEN, qps=None)
    fleet = HollowFleet(fleet_client, interval=30.0)
    creators = [RestClusterClient(urls[0], partition_urls=urls,
                                  token=CREATOR_TOKEN, qps=qps)
                for _ in range(CREATOR_CLIENTS)]
    chunk = 1024
    while True:
        msg = conn.recv()
        if msg == "stop":
            break
        if msg == "modules":
            conn.send("torch" in sys.modules)
            continue
        cmd = msg[0]
        if cmd == "nodes":
            _cmd, count, cpu = msg
            try:
                fleet.register(count, cpu=str(cpu), progress=None)
                fleet.start()
            except Exception as e:  # noqa: BLE001 — the parent must see
                # the registration failure itself
                conn.send(("error", str(e)[:500]))
                continue
            conn.send(("done", count))
        elif cmd == "pods":
            _cmd, count, offset, namespaces = msg
            # pods built a chunk at a time (a 500,000-pod burst must not
            # exist at once), the chunks rotated over the creators; the
            # count sent back is what the servers confirmed created
            rotation, confirmed = [0], [0]

            def send(items):
                client = creators[rotation[0] % len(creators)]
                rotation[0] += 1
                confirmed[0] += client.create_objects_bulk("Pod", items)

            def gen():
                for lo in range(0, count, chunk):
                    for p in make_burst_pods(
                            min(chunk, count - lo),
                            cpu_milli=POD_CPU_MILLI, memory=POD_MEMORY,
                            name_prefix="scale-", uid_prefix="sc-",
                            offset=offset + lo, namespaces=namespaces):
                        yield (0.0, p)

            try:
                stream_arrivals(gen(), send, chunk=chunk, time_scale=0.0)
                conn.send(("done", confirmed[0]))
            except Exception as e:  # noqa: BLE001
                conn.send(("error", str(e)[:500]))
    fleet.stop()
    fleet_client.close()
    for c in creators:
        c.close()
    conn.send("stopped")


# ---------------------------------------------------------------------------
# arms, in this process


def _shard_diag(partitions: int, replicas: int, conflicts: int,
                capacity_rejects: int, balance: Optional[float],
                watch_streams: Optional[int]) -> None:
    from kubernetes_tpu_torch.harness import diagfmt

    seg = diagfmt.format_shards({
        "partitions": partitions, "replicas": replicas,
        "conflicts": conflicts, "capacity_rejects": capacity_rejects,
        "balance": balance, "watch_streams": watch_streams,
    })
    print(diagfmt.format_diag([seg]), file=sys.stderr, flush=True)


def _conflict_counts() -> Dict[str, float]:
    from kubernetes_tpu_torch.metrics.fabric_metrics import fabric_metrics

    return {lbl[0]: v for _, lbl, v
            in fabric_metrics().stale_binds_rejected_total.collect()}


def _conflict_delta(before: Dict[str, float]) -> Dict[str, int]:
    after = _conflict_counts()
    return {k: int(v - before.get(k, 0.0)) for k, v in after.items()
            if v - before.get(k, 0.0) > 0}


def _e2e_ms(replicas) -> Dict[str, float]:
    """p50 and p99 (ms) of the replicas' e2e histograms, buckets summed
    (the batch path's e2e runs from its solve, or its dispatch when
    pipelined, to the bind)."""
    from kubernetes_tpu_torch.metrics.registry import quantile_from_counts

    hist = replicas[0].metrics.e2e_scheduling_duration
    counts: List[int] = []
    for s in replicas:
        got = s.metrics.e2e_scheduling_duration.bucket_counts("scheduled")
        if got:
            counts = [a + b for a, b in zip(counts, got)] if counts else got
    return {"p50": quantile_from_counts(counts, hist.buckets, 0.50) * 1000,
            "p99": quantile_from_counts(counts, hist.buckets, 0.99) * 1000}


def _federate(fed, replicas) -> List[str]:
    """Absorb the replicas' registries and this process's; returns the
    federation's instances, then forgets the ones this row added (the
    federation is process-wide, and a later row counts its own)."""
    from kubernetes_tpu_torch.metrics import default_registry

    for i, sched in enumerate(replicas):
        fed.forget_instance(f"scheduler-{i}")
        fed.absorb_registry(sched.metrics.registry,
                            instance=f"scheduler-{i}")
    fed.forget_instance("scheduler")
    fed.absorb_registry(default_registry(), instance="scheduler")
    instances = sorted(fed.instances())
    for inst in instances:
        if inst.startswith(("scheduler", "apiserver-p", "partition-")):
            fed.forget_instance(inst)
    return instances


def _warm_replicas(rs, namespaces: List[str]) -> None:
    """Solve a sample batch on each replica's batch path: the kernels
    load and each first launch happens before the measured window."""
    samples = make_burst_pods(64, cpu_milli=POD_CPU_MILLI, memory=POD_MEMORY,
                              name_prefix="warm-", uid_prefix="wu-",
                              namespaces=namespaces)
    for bs in rs.batch_schedulers:
        bs.warmup(samples)


def _busy_share(elapsed: float) -> Optional[float]:
    """The card's busy seconds (the device profiler's timing events) over
    the window; None with the profiler off."""
    from kubernetes_tpu_torch.observability.devprof import get_devprof

    dp = get_devprof()
    if not dp.enabled or elapsed <= 0:
        return None
    return dp.summary().get("device_s", 0.0) / elapsed


def run_scale_arm_rest(
    nodes: int,
    pods: int,
    partitions: int,
    replicas: int = 2,
    use_batch: bool = True,
    max_batch: int = 1024,
    qps: Optional[float] = 5000.0,
    node_cpu: int = 32,
    shard_nodes: bool = True,
    wait_timeout: float = 1800.0,
    device=None,
    progress: Optional[Callable[[str], None]] = None,
) -> Dict:
    """One measured arm over the fabric: ``partitions`` apiserver
    processes, the hollow fleet and the pod creators in a child of their
    own, ``replicas`` scheduler replicas here, their batch paths on
    ``device`` (the card unless "cpu")."""
    from kubernetes_tpu_torch.client.restcluster import RestClusterClient
    from kubernetes_tpu_torch.device import resolve_device
    from kubernetes_tpu_torch.harness.perf import (
        ThroughputCollector,
        attach_slo_baseline,
        collect_freshness,
        reset_sli_window,
    )
    from kubernetes_tpu_torch.metrics.federation import metrics_federation
    from kubernetes_tpu_torch.observability.devprof import get_devprof
    from kubernetes_tpu_torch.scheduler.replicas import SchedulerReplicaSet
    from kubernetes_tpu_torch.utils.gctune import tune_for_throughput

    dev = resolve_device(device)
    tune_for_throughput()
    reset_sli_window()
    get_devprof().reset(workload=f"scale10x/p{partitions}")
    conflicts_before = _conflict_counts()
    ctx = mp.get_context("spawn")

    servers = []
    drv = None
    clients: List[RestClusterClient] = []
    rs = None
    collector = None

    def teardown() -> None:
        """Always runs: a failed arm must not leak children holding
        hundreds of thousands of pods."""
        conns = ([drv] if drv else []) + servers
        for conn, _proc in conns:
            try:
                conn.send("stop")
            except (BrokenPipeError, OSError):
                pass
        for conn, proc in conns:
            try:
                if conn.poll(5.0):
                    conn.recv()
            except (EOFError, OSError):
                pass
            proc.join(timeout=5.0)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5.0)

    try:
        urls: List[str] = []
        for i in range(partitions):
            parent_conn, child_conn = ctx.Pipe()
            proc = ctx.Process(target=_scale_apiserver_main,
                               args=(child_conn, i, partitions),
                               daemon=True)
            with _main_hidden():
                proc.start()
            servers.append((parent_conn, proc))
        for conn, proc in servers:
            if not conn.poll(CHILD_START_S):
                raise RuntimeError("a partition apiserver did not start")
            urls.append(conn.recv())
        drv_conn, drv_child = ctx.Pipe()
        drv_proc = ctx.Process(target=_scale_driver_main,
                               args=(drv_child, urls, qps),
                               daemon=True)
        with _main_hidden():
            drv_proc.start()
        drv = (drv_conn, drv_proc)
        namespaces = scale_namespaces(partitions)

        # routing check: each endpoint serves the partition the clients
        # route to it
        probe = RestClusterClient(urls[0], partition_urls=urls,
                                  token=SCHEDULER_TOKEN, qps=None)
        probe.check_partition_topology()
        probe.close()

        # -- the hollow fleet -------------------------------------------
        drv_conn.send(("nodes", nodes, node_cpu))
        status, n = drv_conn.recv()
        if status == "error":
            raise RuntimeError(f"hollow-fleet registration failed: {n}")
        if progress:
            progress(f"scale10x[p{partitions}]: {n} hollow nodes "
                     f"registered")

        # -- scheduler replicas -----------------------------------------
        def client_factory(i: int) -> RestClusterClient:
            c = RestClusterClient(urls[0], partition_urls=urls,
                                  token=SCHEDULER_TOKEN, qps=qps)
            clients.append(c)
            return c

        rs = SchedulerReplicaSet(
            client_factory, count=replicas, shard_pods=True,
            shard_nodes=shard_nodes,
            use_batch=use_batch, max_batch=max_batch, device=dev,
            event_client_factory=client_factory)
        attach_slo_baseline(rs.replicas[0])
        rs.start()
        want = nodes if shard_nodes else nodes * replicas
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and \
                sum(s.cache.node_count() for s in rs.replicas) < want:
            time.sleep(0.1)
        pools = [s.cache.node_count() for s in rs.replicas]
        if progress:
            progress(f"scale10x[p{partitions}]: replica caches warm "
                     f"({pools})")
        if use_batch:
            _warm_replicas(rs, namespaces)
        rs.run()

        # -- the measured burst -----------------------------------------
        collector = ThroughputCollector(
            count_fn=lambda: sum(rs.bound_counts()))
        collector.start()
        get_devprof().reset(workload=f"scale10x/p{partitions}")
        t0 = time.monotonic()
        drv_conn.send(("pods", pods, 0, namespaces))
        created = None
        last_note = 0.0
        deadline = time.monotonic() + wait_timeout
        while True:
            if created is None and drv_conn.poll(0.0):
                status, created = drv_conn.recv()
                if status == "error":
                    raise RuntimeError(f"creator failed: {created}")
            bound = sum(rs.bound_counts())
            if bound >= pods:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"scale10x[p{partitions}]: bound {bound}/{pods} before "
                    f"the deadline")
            if progress and time.monotonic() - last_note > 10:
                last_note = time.monotonic()
                progress(f"scale10x[p{partitions}]: {bound}/{pods} bound")
            time.sleep(0.05)
        rs.flush()
        elapsed = time.monotonic() - t0
        collector.stop()
        busy = _busy_share(elapsed)
        if created is None:
            status, created = drv_conn.recv()

        # -- server truth and invariants --------------------------------
        node_alloc: Dict[str, int] = {}
        node_req: Dict[str, int] = {}
        pods_bound = pods_total = 0
        part_pods: List[int] = []
        servers_import_torch = False
        for conn, _proc in servers:
            conn.send("counts")
            counts = conn.recv()
            pods_bound += counts["pods_bound"]
            pods_total += counts["pods_total"]
            part_pods.append(counts["pods_total"])
            node_alloc.update(counts["node_alloc"])
            servers_import_torch |= counts["import_torch"]
            for name, req in counts["node_req"].items():
                node_req[name] = node_req.get(name, 0) + req
        drv_conn.send("modules")
        fleet_imports_torch = drv_conn.recv()
        oversubscribed = sum(
            1 for name, req in node_req.items()
            if req > node_alloc.get(name, 1 << 62))
        # a pod bound twice within one store is impossible (one key): the
        # cross-partition failure is a pod held by two partitions (more
        # pods stored than created) and a node over its allocatable
        dup_pods = max(0, pods_total - pods)
        double_binds = oversubscribed + dup_pods
        conflicts = _conflict_delta(conflicts_before)

        fed = metrics_federation()
        for i, url in enumerate(urls):
            fed.scrape(url, instance=f"apiserver-p{i}",
                       token=SCHEDULER_TOKEN, fold=True)
        federation_instances = _federate(fed, rs.replicas)
        balance = (min(part_pods) / max(part_pods)) \
            if part_pods and max(part_pods) else None
        watch_streams = sum(len(s.client._watch_threads)
                            for s in rs.replicas)
        _shard_diag(partitions, replicas,
                    sum(v for k, v in conflicts.items() if k != "capacity"),
                    conflicts.get("capacity", 0), balance, watch_streams)
        if pods_bound < pods:
            raise RuntimeError(
                f"store truth disagrees: the servers bound {pods_bound} "
                f"< {pods}")
        return {
            "partitions": partitions,
            "replicas": replicas,
            "nodes": nodes,
            "pods": pods,
            "device": str(dev),
            "pods_per_sec": pods / elapsed if elapsed else 0.0,
            "time_to_all_bound_s": elapsed,
            "e2e_ms": _e2e_ms(rs.replicas),
            "throughput": collector.summary(),
            "created": created,
            "server_pods_bound": pods_bound,
            "server_pods_total": pods_total,
            "lost_pods": max(0, pods - pods_bound),
            "double_binds": double_binds,
            "oversubscribed_nodes": oversubscribed,
            "duplicated_pods": dup_pods,
            "conflicts": conflicts,
            "stale_binds_rejected": rs.stale_binds_rejected(),
            "partition_pods": part_pods,
            "partition_balance": balance,
            "watch_streams": watch_streams,
            "replica_pools": pools,
            "solves": [bs.session.backend.solves
                       for bs in rs.batch_schedulers],
            "device_busy_share": busy,
            "children_import_torch": (servers_import_torch
                                      or fleet_imports_torch),
            "rv_regressions": sum(len(c.rv_regressions) for c in clients),
            "federation_instances": federation_instances,
            "freshness": collect_freshness(),
        }
    finally:
        if collector is not None:
            collector.stop()
        if rs is not None:
            rs.stop()
        for c in clients:
            c.close()
        teardown()


def run_scale_arm_inproc(
    nodes: int,
    pods: int,
    partitions: int,
    replicas: int = 2,
    use_batch: bool = False,
    max_batch: int = 512,
    node_cpu: int = 32,
    shard_pods: bool = True,
    shard_nodes: bool = True,
    wait_timeout: float = 300.0,
    device=None,
    progress: Optional[Callable[[str], None]] = None,
) -> Dict:
    """The in-process arm: a ``PartitionedStore`` (a watch dispatch
    thread a partition, and the bind-time ledger when the replicas share
    nodes) under a hollow fleet and ``replicas`` replicas. It is the conflict
    cell's substrate too: ``shard_pods=False`` makes every replica race
    on every pod. With ``use_batch`` the replicas' batch paths run on
    ``device`` (the card unless "cpu")."""
    from kubernetes_tpu_torch.apiserver.partition import PartitionedStore
    from kubernetes_tpu_torch.harness.perf import (
        collect_freshness,
        reset_sli_window,
    )
    from kubernetes_tpu_torch.kubemark import HollowFleet
    from kubernetes_tpu_torch.metrics.federation import metrics_federation
    from kubernetes_tpu_torch.observability.devprof import get_devprof
    from kubernetes_tpu_torch.scheduler.replicas import SchedulerReplicaSet

    dev = None
    if use_batch:
        from kubernetes_tpu_torch.device import resolve_device

        dev = resolve_device(device)
    reset_sli_window()
    conflicts_before = _conflict_counts()
    store = PartitionedStore(partitions, async_dispatch=partitions > 1,
                             capacity_guard=not shard_nodes)
    namespaces = scale_namespaces(partitions)
    fleet = HollowFleet(store, interval=30.0)
    rs = None
    try:
        fleet.register(nodes, cpu=str(node_cpu))
        fleet.start()
        rs = SchedulerReplicaSet(
            lambda i: store, count=replicas, shard_pods=shard_pods,
            shard_nodes=shard_nodes,
            use_batch=use_batch, max_batch=max_batch, device=dev)
        rs.start()
        pools = [s.cache.node_count() for s in rs.replicas]
        if use_batch:
            _warm_replicas(rs, namespaces)
        rs.run()
        burst = make_burst_pods(pods, cpu_milli=POD_CPU_MILLI,
                                memory=POD_MEMORY, name_prefix="scale-",
                                uid_prefix="sc-", namespaces=namespaces)
        get_devprof().reset(workload=f"scale-inproc/p{partitions}")
        t0 = time.monotonic()
        store.create_pods(burst)
        deadline = time.monotonic() + wait_timeout
        last_note = 0.0
        while time.monotonic() < deadline:
            if store.count_bound() >= pods and rs.pending_count() == 0:
                break
            if progress and time.monotonic() - last_note > 10:
                last_note = time.monotonic()
                progress(f"scale-inproc[p{partitions}]: "
                         f"{store.count_bound()}/{pods} bound")
            time.sleep(0.01)
        rs.flush()
        store.drain()
        elapsed = time.monotonic() - t0
        busy = _busy_share(elapsed)

        bound = [p for p in store.list_pods() if p.spec.node_name]
        node_req: Dict[str, int] = {}
        for p in bound:
            node_req[p.spec.node_name] = node_req.get(
                p.spec.node_name, 0) + POD_CPU_MILLI
        oversubscribed = sum(1 for req in node_req.values()
                             if req > node_cpu * 1000)
        conflicts = _conflict_delta(conflicts_before)

        fed = metrics_federation()
        for i, reg in enumerate(store.partition_registries()):
            fed.absorb_registry(reg, instance=f"partition-{i}")
        federation_instances = _federate(fed, rs.replicas)

        part_pods = [len(p.list_pods()) for p in store.parts]
        balance = (min(part_pods) / max(part_pods)) \
            if max(part_pods) else None
        _shard_diag(partitions, replicas,
                    sum(v for k, v in conflicts.items() if k != "capacity"),
                    conflicts.get("capacity", 0), balance, None)
        return {
            "partitions": partitions,
            "replicas": replicas,
            "nodes": nodes,
            "pods": pods,
            "device": str(dev) if dev is not None else "host",
            "pods_per_sec": pods / elapsed if elapsed else 0.0,
            "time_to_all_bound_s": elapsed,
            "e2e_ms": _e2e_ms(rs.replicas),
            "bound": len(bound),
            "lost_pods": max(0, pods - len(bound)),
            "double_binds": oversubscribed,
            "oversubscribed_nodes": oversubscribed,
            "conflicts": conflicts,
            "stale_binds_rejected": rs.stale_binds_rejected(),
            "partition_pods": part_pods,
            "partition_balance": balance,
            "replica_pools": pools,
            "solves": [bs.session.backend.solves
                       for bs in rs.batch_schedulers],
            "device_busy_share": busy,
            "federation_instances": federation_instances,
            "freshness": collect_freshness(),
        }
    finally:
        if rs is not None:
            rs.stop()
        fleet.stop()
        store.stop()


def run_conflict_cell(nodes: int = 10, pods: int = 38,
                      partitions: int = 2, replicas: int = 2,
                      node_cpu: int = 2,
                      progress: Optional[Callable[[str], None]] = None
                      ) -> Dict:
    """The conflict cell: replicas responsible for every pod (no pod
    hash) over one shared node pool on a tight cluster, so every pod is
    raced by every replica and the bind check and the capacity guards
    must settle each race. Its ``ok``: every pod bound once, no node over
    its allocatable, and conflicts that happened (a cell that never
    conflicted proves nothing). Serial path, host only."""
    cell = run_scale_arm_inproc(
        nodes=nodes, pods=pods, partitions=partitions,
        replicas=replicas, use_batch=False, node_cpu=node_cpu,
        shard_pods=False, shard_nodes=False,
        wait_timeout=120.0, progress=progress)
    cell["conflicts_total"] = sum(cell["conflicts"].values())
    cell["ok"] = (cell["lost_pods"] == 0 and cell["double_binds"] == 0
                  and cell["conflicts_total"] > 0)
    return cell


def run_scale10x_row(
    nodes: int = 50_000,
    pods: int = 500_000,
    partitions: int = 4,
    replicas: int = 2,
    use_batch: bool = True,
    max_batch: int = 1024,
    qps: Optional[float] = 5000.0,
    node_cpu: int = 32,
    wait_timeout: float = 2400.0,
    device=None,
    progress: Optional[Callable[[str], None]] = None,
) -> Dict:
    """``bench.py --config scale10x``: the partitioned arm, the
    one-partition arm at the same size (the A/B), and the conflict
    cell."""
    arm = run_scale_arm_rest(
        nodes=nodes, pods=pods, partitions=partitions,
        replicas=replicas, use_batch=use_batch, max_batch=max_batch,
        qps=qps, node_cpu=node_cpu, wait_timeout=wait_timeout,
        device=device, progress=progress)
    single = run_scale_arm_rest(
        nodes=nodes, pods=pods, partitions=1, replicas=replicas,
        use_batch=use_batch, max_batch=max_batch, qps=qps,
        node_cpu=node_cpu, wait_timeout=wait_timeout, device=device,
        progress=progress)
    cell = run_conflict_cell(nodes=CONFLICT_NODES, pods=CONFLICT_PODS,
                             progress=progress)
    speedup = (arm["pods_per_sec"] / single["pods_per_sec"]) \
        if single["pods_per_sec"] else 0.0
    return {
        "metric": (f"pods_scheduled_per_sec[Scale10x {nodes}nodes/"
                   f"{pods}pods, partitioned fabric {partitions}p x "
                   f"{replicas}r]"),
        "value": arm["pods_per_sec"],
        "unit": "pods/s",
        "p50_latency_ms": arm["e2e_ms"]["p50"],
        "p99_latency_ms": arm["e2e_ms"]["p99"],
        "scale": {"nodes": nodes, "pods": pods,
                  "partitions": partitions, "replicas": replicas},
        "ab": {
            "partitioned_pods_per_sec": arm["pods_per_sec"],
            "single_partition_pods_per_sec": single["pods_per_sec"],
            "speedup": speedup,
            "sharding_pays": speedup >= 1.0,
        },
        "invariants": {
            "lost_pods": arm["lost_pods"] + single["lost_pods"],
            "double_binds": arm["double_binds"] + single["double_binds"],
        },
        "conflict_cell": {
            "conflicts": cell["conflicts"],
            "conflicts_total": cell["conflicts_total"],
            "lost_pods": cell["lost_pods"],
            "double_binds": cell["double_binds"],
            "ok": cell["ok"],
        },
        "arms": {"partitioned": arm, "single": single},
        "children_import_torch": (arm["children_import_torch"]
                                  or single["children_import_torch"]),
        "partition_balance": arm["partition_balance"],
        "watch_streams": arm["watch_streams"],
        "federation_instances": arm["federation_instances"],
        "freshness": arm["freshness"],
    }
