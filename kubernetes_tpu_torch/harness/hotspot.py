"""Hotspot bench + live-resharding cells for the elastic control plane.

The production failure mode a static partition layout cannot answer: ONE
namespace takes most of the write load, so one partition process
saturates while its siblings idle. This harness measures it and the
recovery:

- ``run_hotspot_row`` (``bench.py --config hotspot``) runs three arms
  at the same scale over REAL partition server processes:

  * **balanced** — writes spread uniformly (the fleet's honest
    ceiling);
  * **hotspot** — 80% of writes to one namespace, rebalancer OFF (the
    failure mode, measured);
  * **rebalanced** — same skew with the ``PartitionRebalancer`` live:
    it observes the per-slot/per-namespace write ledgers, SPLITS the
    hot namespace across the keyspace mid-run (writers ride the
    freeze window as ordinary 429 pushback), and throughput recovers.

  The row's verdict is ``recovery_ratio`` — the rebalanced arm's
  post-action steady-state rate over the balanced arm's rate (≥ 0.8
  is the acceptance bar) — plus hard invariants: zero lost pods, zero
  lost watch events (a live informer's final state is compared against
  server truth), and zero relists of unmoved slices.

- ``run_reshard_mini_cell`` is the tier-1-fast live-split cell: 2→3
  partitions at ~200 hollow nodes with writes and an informer active
  THROUGH the migration, asserting the informer's final state equals
  server truth and that no unmoved slice relisted.

Neither runs a scheduler, so neither takes a ``device``. The children
(the partition apiservers, ``harness/scale.py``'s, and the creators)
import no torch.
"""

from __future__ import annotations

import multiprocessing as mp
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.harness.burst import make_burst_pods
from kubernetes_tpu_torch.harness.rest_perf import _main_hidden
from kubernetes_tpu_torch.harness.scale import (
    CREATOR_TOKEN,
    SCHEDULER_TOKEN,
    _scale_apiserver_main,
)

HOT_NS = "hot-tenant"
POD_CPU_MILLI = 100
POD_MEMORY = "50Mi"


def _cold_namespaces(n: int = 9) -> List[str]:
    return [f"cold-{i}" for i in range(n)]


# ---------------------------------------------------------------------------
# creator child (spawned; no torch): skewed open-throttle writes


def _hotspot_creator_main(conn, urls: List[str], seed: int) -> None:
    from kubernetes_tpu_torch.client.restcluster import RestClusterClient
    from kubernetes_tpu_torch.utils.gctune import tune_for_throughput

    tune_for_throughput()
    client = RestClusterClient(urls[0], partition_urls=urls,
                               token=CREATOR_TOKEN, qps=None)
    try:
        client.enable_topology(poll_interval=0.25)
    except Exception:  # noqa: BLE001 — static servers: stay static
        pass
    rng = random.Random(seed)
    while True:
        msg = conn.recv()
        if msg == "stop":
            break
        _cmd, count, offset, hot_share, namespaces, chunk = msg
        confirmed = 0
        made = 0
        try:
            while made < count:
                n = min(chunk, count - made)
                # draw the skew, then group per namespace so each
                # bulk POST is one partition-splittable batch
                per_ns: Dict[str, int] = {}
                for _ in range(n):
                    ns = HOT_NS if rng.random() < hot_share \
                        else rng.choice(namespaces)
                    per_ns[ns] = per_ns.get(ns, 0) + 1
                pods = []
                for ns, k in per_ns.items():
                    pods.extend(make_burst_pods(
                        k, cpu_milli=POD_CPU_MILLI, memory=POD_MEMORY,
                        name_prefix=f"hs{seed}-", uid_prefix=f"hu{seed}-",
                        offset=offset + made + len(pods),
                        namespaces=[ns]))
                confirmed += client.create_objects_bulk("Pod", pods)
                made += n
            conn.send(("done", confirmed))
        except Exception as e:  # noqa: BLE001 — surface the real error
            conn.send(("error", f"{type(e).__name__}: {e}"[:500]))
    client._stop_watches()
    client._drop_conn()
    conn.send("stopped")


# ---------------------------------------------------------------------------
# one measured arm over real partition processes


def run_hotspot_arm(
    pods: int,
    partitions: int = 3,
    hot_share: float = 0.8,
    rebalance: bool = False,
    creator_clients: int = 3,
    chunk: int = 64,
    namespaces: Optional[List[str]] = None,
    wait_timeout: float = 600.0,
    sample_s: float = 0.25,
    rebalance_interval_s: float = 0.4,
    sustain_ticks: int = 2,
    cooldown_s: float = 2.0,
    progress: Optional[Callable[[str], None]] = None,
) -> Dict:
    """One arm: P apiserver processes, skewed creator children, a live
    elastic informer in the parent, and (``rebalance=True``) the
    PartitionRebalancer driving splits/moves through the coordinator."""
    from kubernetes_tpu_torch.apiserver.partition import PartitionTopology
    from kubernetes_tpu_torch.apiserver.reshard import ReshardCoordinator
    from kubernetes_tpu_torch.autoscaler.partitions import (
        PartitionGroup,
        PartitionRebalancer,
        RebalancePolicy,
        RestElasticDriver,
    )
    from kubernetes_tpu_torch.client.informers import SharedInformerFactory
    from kubernetes_tpu_torch.client.restcluster import RestClusterClient

    namespaces = namespaces or _cold_namespaces()
    ctx = mp.get_context("spawn")
    servers = []
    urls: List[str] = []
    for i in range(partitions):
        parent_conn, child_conn = ctx.Pipe()
        proc = ctx.Process(target=_scale_apiserver_main,
                           args=(child_conn, i, partitions),
                           daemon=True)
        with _main_hidden():
            proc.start()
        servers.append((parent_conn, proc))
        urls.append(parent_conn.recv())

    creators = []
    for c in range(creator_clients):
        parent_conn, child_conn = ctx.Pipe()
        proc = ctx.Process(target=_hotspot_creator_main,
                           args=(child_conn, urls, 1000 + c),
                           daemon=True)
        with _main_hidden():
            proc.start()
        creators.append((parent_conn, proc))

    control = RestClusterClient(urls[0], partition_urls=urls,
                                token=SCHEDULER_TOKEN, qps=None,
                                watch_kinds=("Pod",))
    # the freeze budget must comfortably cover the worst-case slice
    # copy (a late split moves 2/3 of the hot tenant): an eta that
    # expires MID-copy thaws writers into the seam the freeze exists
    # to close
    coordinator = ReshardCoordinator(control, freeze_eta=15.0,
                                     evict_grace_s=0.2)
    rebalancer = None
    factory = None
    row: Dict = {}

    def teardown() -> None:
        for conn, _proc in creators + servers:
            try:
                conn.send("stop")
            except (BrokenPipeError, OSError):
                pass
        for conn, proc in creators + servers:
            try:
                if conn.poll(3.0):
                    conn.recv()
            except (EOFError, OSError):
                pass
            proc.join(timeout=3.0)
            if proc.is_alive():
                proc.terminate()

    try:
        # install the live topology (epoch 1) fleet-wide
        topo = PartitionTopology.default(partitions, urls=urls)
        coordinator.install_topology(topo)
        control.enable_topology(poll_interval=0.25)

        # the watch consumer whose zero-loss is the row's invariant
        factory = SharedInformerFactory(control)
        pod_lister = factory.lister_for("Pod")
        factory.start()
        factory.wait_for_cache_sync()

        if rebalance:
            driver = RestElasticDriver(coordinator)
            rebalancer = PartitionRebalancer(
                driver, group=PartitionGroup(
                    min_partitions=partitions,
                    max_partitions=partitions, cooldown_s=cooldown_s),
                policy=RebalancePolicy(min_rate=30.0,
                                       sustain_ticks=sustain_ticks),
                interval_s=rebalance_interval_s)
            rebalancer.run()

        # -- measured injection --------------------------------------
        share = pods // len(creators)
        t0 = time.monotonic()
        for c, (conn, _proc) in enumerate(creators):
            n = share if c < len(creators) - 1 \
                else pods - share * (len(creators) - 1)
            conn.send(("pods", n, c * (pods + 16), hot_share,
                       namespaces, chunk))
        series: List[Tuple[float, int]] = []
        done = 0
        confirmed = 0
        deadline = time.monotonic() + wait_timeout
        last_note = 0.0
        while done < len(creators) and time.monotonic() < deadline:
            total = 0
            for p in range(len(control.partition_urls)):
                try:
                    got = coordinator._admin_get(p)
                    total += int(got.get("mutations") or 0)
                except Exception:  # noqa: BLE001 — mid-migration blip
                    pass
            series.append((time.monotonic() - t0, total))
            for conn, _proc in creators:
                if conn.poll(0.0):
                    status, n = conn.recv()
                    if status == "error":
                        raise RuntimeError(f"creator failed: {n}")
                    confirmed += n
                    done += 1
            if progress and time.monotonic() - last_note > 5:
                last_note = time.monotonic()
                progress(f"hotspot[{'rebal' if rebalance else 'static'}"
                         f" {hot_share:.0%}]: t={series[-1][0]:.1f}s "
                         f"mutations={series[-1][1]}")
            time.sleep(sample_s)
        if done < len(creators):
            raise TimeoutError(
                f"hotspot arm: {done}/{len(creators)} creators done "
                f"before deadline")
        elapsed = time.monotonic() - t0
        if rebalancer is not None:
            rebalancer.stop()
        time.sleep(1.5)   # quiesce: streams drain, informer catches up

        # -- server truth (key-level union across partitions) --------
        # ``confirmed`` is a client-side LOWER bound: a bulk create
        # whose response is lost re-sends, and the retry reports only
        # the items that were still new — so raw count comparisons
        # would misread retry under-counting as duplication. Key-level
        # union is exact: a real duplicate is one key on two servers.
        union: Dict[Tuple[str, str], str] = {}
        dup_pods = 0
        per_part: List[int] = []
        for p in range(len(control.partition_urls)):
            objs, _rv = control._list_with_rv("Pod", partition=p)
            per_part.append(len(objs))
            for o in objs:
                key = (o.metadata.namespace, o.metadata.name)
                if key in union:
                    dup_pods += 1
                union[key] = o.metadata.resource_version
        pods_total = len(union)
        inf = {(o.metadata.namespace, o.metadata.name):
               o.metadata.resource_version for o in pod_lister.list()}
        missing = [k for k in union if k not in inf]
        extra = [k for k in inf if k not in union]
        stale = [k for k, rv in union.items()
                 if k in inf and inf[k] != rv]
        informer_pods = len(inf)
        lost_pods = max(0, confirmed - pods_total)
        lost_watches = len(missing) + len(extra) + len(stale)
        unmoved_relists = sum(
            v for (kind, p), v in control.stream_relists.items())

        # recovered steady-state rate: mutations/s over the window
        # AFTER the last rebalance action landed (trailing idle
        # samples — the poll loop outliving the creators — trimmed so
        # a short run's tail can't dilute the recovered rate)
        def window_rate(frac: float) -> float:
            live = list(series)
            while len(live) > 2 and live[-1][1] <= live[-2][1]:
                live.pop()
            if len(live) < 3:
                return confirmed / elapsed if elapsed else 0.0
            start_idx = int(len(live) * (1.0 - frac))
            if rebalancer is not None and rebalancer.actions:
                acted_rel = max(a["at"] for a in rebalancer.actions) \
                    - t0
                for i, (t_rel, _v) in enumerate(live):
                    if t_rel >= acted_rel:
                        start_idx = i
                        break
            # a usable window needs real samples: when the action
            # landed near the end, widen back (conservative — the
            # pre-action throttled time only UNDERSTATES recovery)
            start_idx = min(start_idx,
                            len(live) - max(4, len(live) // 5))
            start_idx = max(0, start_idx)
            cut = live[start_idx]
            last = live[-1]
            dt = last[0] - cut[0]
            return (last[1] - cut[1]) / dt if dt > 0 else 0.0

        # the rebalancer drives THIS coordinator, so its action reports
        # are already in coordinator.reports — identity-dedupe
        migrations = list(coordinator.reports)
        if rebalancer is not None:
            for a in rebalancer.actions:
                rep = a.get("report")
                if rep and all(rep is not m for m in migrations):
                    migrations.append(rep)
        arm = {
            "pods": pods,
            "partitions": partitions,
            "hot_share": hot_share,
            "rebalance": rebalance,
            "confirmed": confirmed,
            "pods_per_sec": round(confirmed / elapsed, 1)
            if elapsed else 0.0,
            "recovered_rate": round(window_rate(0.35), 1),
            "elapsed_s": round(elapsed, 2),
            "server_pods_total": pods_total,
            "per_partition_pods": per_part,
            "lost_pods": lost_pods,
            "duplicated_pods": dup_pods,
            "informer_pods": informer_pods,
            "lost_watches": lost_watches,
            "unmoved_relists": unmoved_relists,
            "rv_regressions": len(control.rv_regressions),
            "epoch": control.topology_epoch,
            "migrations": migrations,
            "rebalancer_actions": [a["action"] for a in
                                   (rebalancer.actions
                                    if rebalancer else [])],
        }
        return arm
    finally:
        if rebalancer is not None:
            rebalancer.stop()
        if factory is not None:
            factory.stop()
        control._stop_watches()
        control._drop_conn()
        teardown()


def run_hotspot_row(
    pods: int = 24_000,
    partitions: int = 3,
    hot_share: float = 0.8,
    creator_clients: int = 3,
    wait_timeout: float = 600.0,
    rebalance_interval_s: float = 0.3,
    sustain_ticks: int = 2,
    cooldown_s: float = 1.0,
    progress: Optional[Callable[[str], None]] = None,
) -> Dict:
    """The committed bench row: balanced / hotspot / rebalanced arms,
    recovery ratio + invariants, and the ``reshard[...]`` diag."""
    balanced = run_hotspot_arm(
        pods=pods, partitions=partitions, hot_share=0.0,
        rebalance=False, creator_clients=creator_clients,
        wait_timeout=wait_timeout, progress=progress)
    hotspot = run_hotspot_arm(
        pods=pods, partitions=partitions, hot_share=hot_share,
        rebalance=False, creator_clients=creator_clients,
        wait_timeout=wait_timeout, progress=progress)
    rebalanced = run_hotspot_arm(
        pods=pods, partitions=partitions, hot_share=hot_share,
        rebalance=True, creator_clients=creator_clients,
        wait_timeout=wait_timeout,
        rebalance_interval_s=rebalance_interval_s,
        sustain_ticks=sustain_ticks, cooldown_s=cooldown_s,
        progress=progress)

    balanced_rate = balanced["pods_per_sec"]
    recovery_ratio = (rebalanced["recovered_rate"] / balanced_rate) \
        if balanced_rate else 0.0
    hot_ratio = (hotspot["pods_per_sec"] / balanced_rate) \
        if balanced_rate else 0.0
    invariants = {
        "lost_pods": sum(a["lost_pods"] for a in
                         (balanced, hotspot, rebalanced)),
        "duplicated_pods": sum(a["duplicated_pods"] for a in
                               (balanced, hotspot, rebalanced)),
        "lost_watches": sum(a["lost_watches"] for a in
                            (balanced, hotspot, rebalanced)),
        "unmoved_relists": rebalanced["unmoved_relists"],
        "rv_regressions": sum(a["rv_regressions"] for a in
                              (balanced, hotspot, rebalanced)),
        "rebalancer_acted": bool(rebalanced["rebalancer_actions"]),
    }
    invariants_ok = (invariants["lost_pods"] == 0
                     and invariants["duplicated_pods"] == 0
                     and invariants["lost_watches"] == 0
                     and invariants["unmoved_relists"] == 0
                     and invariants["rv_regressions"] == 0
                     and invariants["rebalancer_acted"])
    frozen_ms = sum(m.get("frozen_ms", 0.0)
                    for m in rebalanced["migrations"])
    _reshard_diag(rebalanced, frozen_ms, invariants)
    return {
        "metric": (f"hotspot_recovery[{partitions}p, one namespace "
                   f"{hot_share:.0%} of {pods} writes, elastic "
                   f"control plane]"),
        "value": round(recovery_ratio, 3),
        "unit": "ratio",
        "balanced_pods_per_sec": balanced_rate,
        "hotspot_pods_per_sec": hotspot["pods_per_sec"],
        "hotspot_ratio_vs_balanced": round(hot_ratio, 3),
        "rebalanced_pods_per_sec": rebalanced["pods_per_sec"],
        "recovered_rate": rebalanced["recovered_rate"],
        "recovery_ratio": round(recovery_ratio, 3),
        "migrations": rebalanced["migrations"],
        "rebalancer_actions": rebalanced["rebalancer_actions"],
        "epoch": rebalanced["epoch"],
        "frozen_ms_total": round(frozen_ms, 2),
        "per_partition_pods": {
            "hotspot": hotspot["per_partition_pods"],
            "rebalanced": rebalanced["per_partition_pods"],
        },
        "invariants": invariants,
        "invariants_ok": invariants_ok,
        "lost_watches": invariants["lost_watches"],
    }


def _reshard_diag(rebalanced: Dict, frozen_ms: float,
                  invariants: Dict) -> None:
    import sys

    from kubernetes_tpu_torch.harness import diagfmt

    seg = diagfmt.format_reshard({
        "moves": len(rebalanced["migrations"]),
        "frozen_ms": frozen_ms,
        "epoch": rebalanced["epoch"],
        "lost_watches": invariants["lost_watches"],
    })
    print(diagfmt.format_diag([seg]), file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# the tier-1 mini-cell: live 2→3 split under writes + informer + fleet


def run_reshard_mini_cell(
    nodes: int = 200,
    pods: int = 240,
    partitions_from: int = 2,
    write_batch: int = 6,
    settle_s: float = 1.2,
    progress: Optional[Callable[[str], None]] = None,
) -> Dict:
    """CI-fast live split: ``partitions_from`` in-process apiservers
    (real HTTP, shared process — spawn cost without the spawn), a
    hollow-node fleet, an elastic client + SharedInformerFactory, and a
    writer running THROUGH a ``split_to`` migration. Asserted by the
    caller: informer ≡ server truth, zero lost, zero relists of
    unmoved slices, bounded freeze."""
    from kubernetes_tpu_torch.apiserver.partition import PartitionTopology
    from kubernetes_tpu_torch.apiserver.reshard import ReshardCoordinator
    from kubernetes_tpu_torch.apiserver.rest import APIServer
    from kubernetes_tpu_torch.apiserver.store import ClusterStore
    from kubernetes_tpu_torch.client.informers import SharedInformerFactory
    from kubernetes_tpu_torch.client.restcluster import RestClusterClient
    from kubernetes_tpu_torch.kubemark import HollowFleet

    servers = [APIServer(store=ClusterStore(),
                         partition=(i, partitions_from)).start()
               for i in range(partitions_from)]
    urls = [s.url for s in servers]
    topo = PartitionTopology.default(partitions_from, urls=urls)
    for s in servers:
        s.install_topology(topo)

    client = RestClusterClient(urls[0], partition_urls=urls,
                               watch_kinds=("Pod", "Node"))
    coordinator = ReshardCoordinator(client, freeze_eta=5.0,
                                     evict_grace_s=0.1)
    factory = None
    fleet = None
    new_server = None
    try:
        assert client.enable_topology(poll_interval=0.15)
        factory = SharedInformerFactory(client)
        pod_lister = factory.lister_for("Pod")
        node_lister = factory.lister_for("Node")
        fleet = HollowFleet(client, interval=30.0)
        fleet.register(nodes, cpu="16", chunk=256)
        fleet.start()
        factory.start()
        factory.wait_for_cache_sync()
        if progress:
            progress(f"mini-cell: {nodes} hollow nodes registered")

        namespaces = [f"mc-{i}" for i in range(8)]
        stop = threading.Event()
        errors: List[str] = []
        confirmed = [0]

        def writer() -> None:
            i = 0
            while not stop.is_set():
                batch = make_burst_pods(
                    write_batch, cpu_milli=POD_CPU_MILLI,
                    memory=POD_MEMORY, name_prefix="mc-",
                    uid_prefix="mcu-", offset=i,
                    namespaces=namespaces)
                try:
                    confirmed[0] += client.create_objects_bulk(
                        "Pod", batch)
                except Exception as e:  # noqa: BLE001
                    errors.append(f"{type(e).__name__}: {e}")
                    return
                i += write_batch
                time.sleep(0.01)

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        time.sleep(0.4)

        # the LIVE SPLIT: a third partition joins and takes its share
        new_server = APIServer(
            store=ClusterStore(),
            partition=(partitions_from, partitions_from + 1)).start()
        report = coordinator.split_to(new_server.url)
        if progress:
            progress(f"mini-cell: split report {report}")
        time.sleep(0.6)   # keep writing through the new layout
        stop.set()
        t.join(timeout=5.0)
        time.sleep(settle_s)   # quiesce: informer catches up

        all_servers = servers + [new_server]
        union: Dict[tuple, str] = {}
        duplicates = 0
        for s in all_servers:
            for p in s.store.list_pods():
                key = (p.namespace, p.metadata.name)
                if key in union:
                    duplicates += 1
                union[key] = p.metadata.resource_version
        node_union = {
            n.name for s in all_servers for n in s.store.list_nodes()}
        inf = {(o.metadata.namespace, o.metadata.name):
               o.metadata.resource_version for o in pod_lister.list()}
        missing = [k for k in union if k not in inf]
        extra = [k for k in inf if k not in union]
        stale = [k for k in union if k in inf and inf[k] != union[k]]
        moved_relists = sum(
            v for (kind, p), v in client.stream_relists.items())
        return {
            "errors": errors,
            "confirmed": confirmed[0],
            "server_pods": len(union),
            "duplicates": duplicates,
            "nodes": len(node_union),
            "informer_nodes": len(node_lister.list()),
            "informer_pods": len(inf),
            "missing": missing[:5],
            "extra": extra[:5],
            "stale": stale[:5],
            "lost_watches": len(missing) + len(extra) + len(stale),
            "unmoved_relists": moved_relists,
            "rv_regressions": list(client.rv_regressions),
            "epoch": client.topology_epoch,
            "moved_objects": report["moved_objects"],
            "frozen_ms": report["frozen_ms"],
            "handoff_fetches": client.handoff_fetches,
        }
    finally:
        if factory is not None:
            factory.stop()
        if fleet is not None:
            fleet.stop()
        client._stop_watches()
        client._drop_conn()
        for s in servers + ([new_server] if new_server else []):
            s.shutdown_server()
