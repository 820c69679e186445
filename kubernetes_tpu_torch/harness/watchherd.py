"""The watch herd: the read tier under informer fan-out.

When hundreds of informers hang list and watch streams off the control
plane, do read replicas (``apiserver/readtier.py``) scale the events
delivered without slowing the writes and without weakening the watch
contract (no event lost, none applied twice, relists only where a
process died)? This harness measures it over real processes and
sockets:

- **owner**: one spawned apiserver with a synchronous WAL (the
  subscription's resume window across a restart);
- **replicas**: N spawned ``ReadReplica`` processes, each seeded from
  ``?snapshot=1`` and following the owner's commit stream, serving lists
  and watches from their own store, watch cache and dispatch;
- **herd**: K spawned children of M ``_MiniInformer`` threads, each a
  raw HTTP list and watch loop on one endpoint (its replica), with the
  sibling replicas and the owner to fail over to. An informer drops a
  frame it already applied (by the object's high-water version), so a
  failover to a lagging sibling re-receives events without applying
  them twice (``dup_suppressed``);
- **writer**: a paced open-loop create and delete stream into the owner
  (writes never go to replicas), seeded, so every arm commits the same
  operations: the arm without replicas is a differential control (the
  same final state hash, or the row fails);
- **hollow nodes**: a ``HollowFleet`` renewing leases through the same
  client (lease renewals take no resourceVersion, so the arms stay
  identical).

Each arm's headline: events delivered a second, from the writer's start
to the instant every informer's state hash equals the owner's. The
scaling row judges events delivered per owner CPU-second (the owner
process's rusage over the window): every process shares the host's
cores, so wall-clock throughput measures the host, while what the read
tier scales is how much fan-out one second of the owner, the one process
that cannot be replicated, buys. With no replica the owner sends every
frame to every informer; with four it sends four subscription copies.
The wall-clock rates stand beside it. Bars: read scaling at least
``READ_SCALING_FLOOR_X``, writes within ``WRITE_FLAT_TOLERANCE`` of the
arm without replicas, replication-lag p99 within the budget, no lost or
doubled event, no relist outside a killed process.

Chaos cells (``run_readtier_cell``):

- ``replica_kill``: one replica SIGKILLed mid-herd: its informers fail
  over and relist once each; informers of surviving replicas relist
  never; nothing lost at quiesce.
- ``owner_restart``: the owner SIGKILLed with replicas live and
  restarted on the same port from its WAL: replicas resume their
  subscriptions from their cursors (``resumes >= 1``, ``reseeds == 0``)
  and their watchers' streams never break (no relist).
- ``lag_fence``: one replica applies with an injected delay until its
  replication lag is over budget: it fences, its streams and lists
  close, its informers read elsewhere, the relists stay with them.

The spawned owner, replica and herd children import no torch; nothing
here runs a scheduler or touches the card.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import os
import random
import shutil
import socket
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple
from urllib.parse import urlparse

from kubernetes_tpu_torch.client.restcluster import RestClusterClient
from kubernetes_tpu_torch.harness.rest_perf import _main_hidden

READTIER_SCENARIOS = ("replica_kill", "owner_restart", "lag_fence")

DEFAULT_LAG_BUDGET_S = 0.5
READ_SCALING_FLOOR_X = 1.5
WRITE_FLAT_TOLERANCE = 0.15


def _state_hash(items: Sequence[Tuple[str, str, int]]) -> str:
    """Canonical digest of a (namespace, name, resourceVersion) set —
    computed identically by the owner-truth side (parent) and every
    informer (herd children), so convergence is one string compare."""
    return hashlib.sha1(
        json.dumps(sorted(items)).encode()).hexdigest()[:16]


def _host_port(url: str) -> Tuple[str, int]:
    p = urlparse(url)
    return p.hostname or "127.0.0.1", int(p.port or 80)


# ---------------------------------------------------------------------------
# spawned children (mirrors the upgrade harness's process idiom)


def _owner_main(conn, port: int, wal_dir: str, restore: bool) -> None:
    """Owner partition apiserver child. ``restore=True`` is the
    post-SIGKILL respawn: rebuild the store from the WAL directory and
    PRESERVE the log — a fresh snapshot would truncate the very tail
    the replicas' subscription cursors resume from."""
    from kubernetes_tpu_torch.apiserver.rest import APIServer
    from kubernetes_tpu_torch.apiserver.store import ClusterStore
    from kubernetes_tpu_torch.apiserver.wal import attach_wal, restore_store
    from kubernetes_tpu_torch.utils.gctune import tune_for_throughput

    tune_for_throughput()
    store = ClusterStore()
    if restore:
        restore_store(wal_dir, store)
    wal = attach_wal(store, wal_dir, snapshot_every=1_000_000,
                     async_serialize=False, preserve_log=restore)
    server = None
    for _ in range(40):
        # a restart reuses the dead owner's port so replica and client
        # URLs stay valid; the kernel may briefly hold it
        try:
            server = APIServer(store=store, port=port).start()
            break
        except OSError:
            time.sleep(0.25)
    if server is None:
        conn.send("bind-failed")
        return
    server.wal_dir = wal_dir  # 410-resume path reads the log tail
    conn.send(server.url)
    while True:
        msg = conn.recv()
        if msg == "stop":
            break
        if isinstance(msg, tuple) and msg[0] == "topology":
            from kubernetes_tpu_torch.apiserver.partition import PartitionTopology

            server.install_topology(PartitionTopology.from_dict(msg[1]))
            conn.send(server.partition_topology.epoch)
        elif msg == "counts":
            import resource

            ru = resource.getrusage(resource.RUSAGE_SELF)
            pods = sorted(
                (p.namespace, p.metadata.name,
                 int(p.metadata.resource_version))
                for p in store.list_pods())
            conn.send({"rv": store.current_rv(), "pods": pods,
                       "nodes": len(store.list_nodes()),
                       "cpu_s": ru.ru_utime + ru.ru_stime})
    server.shutdown_server()
    if wal is not None:
        wal.close()
    conn.send("stopped")


def _replica_main(conn, owner_url: str, replica_id: str,
                  lag_budget_s: float, apply_delay: float) -> None:
    """Read-replica child: one ``ReadReplica`` (mirror store + read-only
    apiserver + subscription tail). ``apply_delay`` is the lag-fence
    chaos hook — a per-event apply stall that drives replication lag
    past the budget."""
    from kubernetes_tpu_torch.apiserver.readtier import ReadReplica
    from kubernetes_tpu_torch.metrics.freshness_metrics import freshness_metrics
    from kubernetes_tpu_torch.utils.gctune import tune_for_throughput

    tune_for_throughput()
    rep = ReadReplica(owner_url, partition=(0, 1), replica_id=replica_id,
                      lag_budget_s=lag_budget_s, apply_delay=apply_delay)
    try:
        rep.start(seed_timeout=30.0)
    except Exception as exc:  # noqa: BLE001 — surfaced to the parent
        conn.send(f"error: {exc}")
        return
    conn.send(rep.url)
    hist = freshness_metrics().replication_lag_seconds
    while True:
        msg = conn.recv()
        if msg == "stop":
            break
        if msg == "stats":
            st = rep.stats()
            rid = rep.repl.replica_id
            st["lag_p99_ms"] = round(
                hist.quantile(0.99, rid) * 1000, 2) \
                if hist.count(rid) else 0.0
            conn.send(st)
    rep.stop()
    conn.send("stopped")


# ---------------------------------------------------------------------------
# the informer herd


class _MiniInformer(threading.Thread):
    """One raw-HTTP list+watch consumer: JSON list, then a chunked
    ``?watch=1&resourceVersion=`` stream, against an endpoint list
    (primary replica first, siblings and owner as failover). Carries
    the elastic client's per-key RV high-water filter so a failover to
    a lagging sibling suppresses — never double-applies — events it
    already saw, and a stale list cannot resurrect a deleted object or
    drop one newer than the snapshot."""

    def __init__(self, index: int, urls: Sequence[str],
                 stop: threading.Event, kind_path: str = "pods"):
        super().__init__(daemon=True, name=f"informer-{index}")
        self.index = index
        self.endpoints = [_host_port(u) for u in urls]
        self.ep = 0
        self.kind_path = kind_path
        self._halt = stop
        self._conn_lock = threading.Lock()
        self._conn: Optional[http.client.HTTPConnection] = None
        self._klock = threading.Lock()
        self.known: Dict[Tuple[str, str], int] = {}
        self.high: Dict[Tuple[str, str], int] = {}
        self.delivered = 0
        self.dup_suppressed = 0
        self.lists = 0
        self.reroutes = 0
        self.errors = 0
        self.synced = threading.Event()

    # -- lifecycle ----------------------------------------------------
    def run(self) -> None:
        backoff = 0.05
        while not self._halt.is_set():
            try:
                rv = self._list()
                backoff = 0.05
                self._watch(rv)
                # clean end-of-stream (server flush/close): retry the
                # SAME endpoint — the next list probe decides whether
                # this endpoint is actually gone (fenced lists 503)
            except (OSError, ValueError, KeyError, AttributeError):
                if self._halt.is_set():
                    break  # the stop-path sever, not a real failure
                self.errors += 1
                self._advance()
                time.sleep(backoff)
                backoff = min(backoff * 2, 0.5)

    def sever(self) -> None:
        """Unblock a readline parked on a live stream (stop path)."""
        with self._conn_lock:
            conn, self._conn = self._conn, None
        if conn is not None:
            try:
                if conn.sock is not None:
                    conn.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except Exception:  # noqa: BLE001
                pass

    def _track(self, conn) -> None:
        with self._conn_lock:
            self._conn = conn

    def _advance(self) -> None:
        if len(self.endpoints) > 1:
            self.ep = (self.ep + 1) % len(self.endpoints)
            self.reroutes += 1

    # -- list+watch ---------------------------------------------------
    def _list(self) -> int:
        host, port = self.endpoints[self.ep]
        conn = http.client.HTTPConnection(host, port, timeout=15)
        self._track(conn)
        try:
            conn.request("GET", f"/api/v1/{self.kind_path}")
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                raise OSError(f"list status {resp.status}")
            doc = json.loads(body)
        finally:
            try:
                conn.close()
            except Exception:  # noqa: BLE001
                pass
        list_rv = int(doc.get("resourceVersion") or 0)
        fresh: Dict[Tuple[str, str], int] = {}
        for item in doc.get("items", ()):
            m = item.get("metadata", item)
            key = (m.get("namespace") or "", m["name"])
            rv = int(m.get("resourceVersion") or 0)
            # a snapshot older than an already-applied DELETE must not
            # resurrect the object
            if rv >= self.high.get(key, -1):
                fresh[key] = rv
        with self._klock:
            # keep anything newer than the snapshot itself (a lagging
            # sibling's list predates events this informer already has)
            for key, rv in self.known.items():
                if rv > list_rv:
                    fresh[key] = rv
            self.known = fresh
            self.lists += 1
        return list_rv

    def _watch(self, rv: int) -> None:
        host, port = self.endpoints[self.ep]
        conn = http.client.HTTPConnection(host, port, timeout=300)
        conn.connect()
        conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._track(conn)
        try:
            conn.request(
                "GET",
                f"/api/v1/{self.kind_path}?watch=1&resourceVersion={rv}")
            resp = conn.getresponse()
            if resp.status != 200:
                resp.read()
                raise OSError(f"watch status {resp.status}")
            self.synced.set()
            while not self._halt.is_set():
                line = resp.readline()
                if not line:
                    return
                try:
                    msg = json.loads(line)
                    wire = msg["object"]
                except (ValueError, KeyError, TypeError):
                    return  # torn frame: relist
                self._apply(msg.get("type"), wire)
        finally:
            try:
                conn.close()
            except Exception:  # noqa: BLE001
                pass

    def _apply(self, etype: Optional[str], wire: dict) -> None:
        m = wire.get("metadata", wire)
        key = (m.get("namespace") or "", m["name"])
        rv = int(m.get("resourceVersion") or 0)
        with self._klock:
            if rv <= self.high.get(key, -1):
                # cursor handoff: a frame this informer already applied
                # before failing over — suppressed, never re-applied
                self.dup_suppressed += 1
                return
            self.high[key] = rv
            if etype == "DELETED":
                self.known.pop(key, None)
            else:
                self.known[key] = rv
            self.delivered += 1

    # -- observation --------------------------------------------------
    def snapshot(self) -> dict:
        with self._klock:
            items = [(ns, name, rv)
                     for (ns, name), rv in self.known.items()]
            return {
                "hash": _state_hash(items),
                "objects": len(items),
                "delivered": self.delivered,
                "dup_suppressed": self.dup_suppressed,
                "relists": max(0, self.lists - 1),
                "reroutes": self.reroutes,
                "errors": self.errors,
                "endpoint": self.ep,
            }


def _herd_main(conn, informer_urls: List[List[str]]) -> None:
    """Herd child: one thread-herd of ``_MiniInformer``s, observable
    over the pipe ("synced" / "snapshot") and stopped with a final
    snapshot so the parent gets exact terminal counters."""
    stop = threading.Event()
    informers = [_MiniInformer(i, urls, stop)
                 for i, urls in enumerate(informer_urls)]
    for inf in informers:
        inf.start()
    conn.send("ready")
    while True:
        msg = conn.recv()
        if msg == "synced":
            conn.send(sum(1 for i in informers if i.synced.is_set()))
        elif msg == "snapshot":
            conn.send([i.snapshot() for i in informers])
        elif msg == "stop":
            stop.set()
            for inf in informers:
                inf.sever()
            for inf in informers:
                inf.join(timeout=2.0)
            conn.send([i.snapshot() for i in informers])
            break


# ---------------------------------------------------------------------------
# fleet orchestration (parent side)


class _ReadTierFleet:
    """Owner + read replicas + herd children as real processes."""

    def __init__(self, progress: Optional[Callable] = None):
        import multiprocessing as mp

        self.ctx = mp.get_context("spawn")
        self.progress = progress
        self.wal_root = tempfile.mkdtemp(prefix="ktpu-readtier-wal-")
        self.owner: Optional[list] = None      # [conn, proc]
        self.owner_url = ""
        self.owner_port = 0
        self.replicas: List[Optional[list]] = []
        self.replica_urls: List[str] = []
        self.herds: List[list] = []
        self.herd_primaries: List[List[Optional[int]]] = []

    def _say(self, msg: str) -> None:
        if self.progress:
            self.progress(msg)

    # -- owner --------------------------------------------------------
    def start_owner(self, port: int = 0, restore: bool = False,
                    timeout: float = 60.0) -> str:
        wal_dir = os.path.join(self.wal_root, "owner")
        os.makedirs(wal_dir, exist_ok=True)
        parent_conn, child_conn = self.ctx.Pipe()
        proc = self.ctx.Process(
            target=_owner_main,
            args=(child_conn, port, wal_dir, restore), daemon=True)
        with _main_hidden():
            proc.start()
        if not parent_conn.poll(timeout):
            raise RuntimeError("owner child did not come up")
        url = parent_conn.recv()
        if url == "bind-failed":
            raise RuntimeError("owner child could not bind its port")
        self.owner = [parent_conn, proc]
        self.owner_url = url
        self.owner_port = _host_port(url)[1]
        return url

    def kill_owner(self) -> None:
        _conn, proc = self.owner
        proc.kill()
        proc.join(timeout=5.0)

    def restart_owner(self, timeout: float = 60.0) -> str:
        """Respawn on the SAME port from the (possibly torn) WAL."""
        return self.start_owner(port=self.owner_port, restore=True,
                                timeout=timeout)

    def owner_counts(self) -> dict:
        conn, _proc = self.owner
        conn.send("counts")
        if not conn.poll(30.0):
            raise RuntimeError("owner counts timed out")
        return conn.recv()

    def advertise(self) -> int:
        """Install a topology doc on the owner advertising the live
        replica URLs — the path ``RestClusterClient`` discovers the
        read tier through (``refresh_topology`` → ``replicas`` field →
        ``set_read_replicas``)."""
        from kubernetes_tpu_torch.apiserver.partition import PartitionTopology

        topo = PartitionTopology.default(1, urls=[self.owner_url])
        urls = [u for u in self.replica_urls if u]
        if urls:
            topo = topo.evolve(replicas={0: urls})
        conn, _proc = self.owner
        conn.send(("topology", topo.to_dict()))
        if not conn.poll(10.0):
            raise RuntimeError("topology install timed out")
        return conn.recv()

    # -- replicas -----------------------------------------------------
    def start_replicas(self, count: int,
                       lag_budget_s: float = DEFAULT_LAG_BUDGET_S,
                       apply_delays: Sequence[float] = (),
                       timeout: float = 60.0) -> List[str]:
        for i in range(count):
            parent_conn, child_conn = self.ctx.Pipe()
            delay = apply_delays[i] if i < len(apply_delays) else 0.0
            proc = self.ctx.Process(
                target=_replica_main,
                args=(child_conn, self.owner_url, f"r{i}",
                      lag_budget_s, delay), daemon=True)
            with _main_hidden():
                proc.start()
            self.replicas.append([parent_conn, proc])
        for i, (conn, _proc) in enumerate(self.replicas):
            if not conn.poll(timeout):
                raise RuntimeError(f"replica r{i} did not come up")
            url = conn.recv()
            if isinstance(url, str) and url.startswith("error:"):
                raise RuntimeError(f"replica r{i} failed: {url}")
            self.replica_urls.append(url)
        self._say(f"[readtier] {count} replicas seeded")
        return list(self.replica_urls)

    def kill_replica(self, i: int) -> None:
        _conn, proc = self.replicas[i]
        proc.kill()
        proc.join(timeout=5.0)
        self.replicas[i] = None

    def replica_stats(self) -> List[dict]:
        out = []
        for entry in self.replicas:
            if entry is None:
                continue
            conn, proc = entry
            if not proc.is_alive():
                continue
            try:
                conn.send("stats")
                if conn.poll(10.0):
                    out.append(conn.recv())
            except (BrokenPipeError, EOFError, OSError):
                pass
        return out

    # -- herd ---------------------------------------------------------
    def endpoints_for(self, i: int) -> Tuple[List[str], Optional[int]]:
        """Informer ``i``'s endpoint list (primary first) and the index
        of its primary replica (None = pinned to the owner)."""
        n = len(self.replica_urls)
        if n == 0:
            return [self.owner_url], None
        primary = i % n
        order = [self.replica_urls[(primary + j) % n] for j in range(n)]
        order.append(self.owner_url)
        return order, primary

    def start_herd(self, informers: int, children: int,
                   timeout: float = 60.0) -> None:
        per = [informers // children +
               (1 if c < informers % children else 0)
               for c in range(children)]
        base = 0
        for c in range(children):
            urls, primaries = [], []
            for i in range(base, base + per[c]):
                eps, primary = self.endpoints_for(i)
                urls.append(eps)
                primaries.append(primary)
            base += per[c]
            parent_conn, child_conn = self.ctx.Pipe()
            proc = self.ctx.Process(
                target=_herd_main, args=(child_conn, urls), daemon=True)
            with _main_hidden():
                proc.start()
            self.herds.append([parent_conn, proc])
            self.herd_primaries.append(primaries)
        for c, (conn, _proc) in enumerate(self.herds):
            if not conn.poll(timeout):
                raise RuntimeError(f"herd child {c} did not come up")
            conn.recv()

    def wait_synced(self, total: int, timeout: float = 60.0) -> int:
        deadline = time.monotonic() + timeout
        synced = 0
        while time.monotonic() < deadline:
            synced = 0
            for conn, _proc in self.herds:
                conn.send("synced")
                if conn.poll(10.0):
                    synced += conn.recv()
            if synced >= total:
                break
            time.sleep(0.1)
        return synced

    def herd_snapshots(self) -> List[dict]:
        """Flat per-informer snapshots, annotated with each informer's
        pinned primary replica (the confinement checks key off it)."""
        out: List[dict] = []
        for c, (conn, _proc) in enumerate(self.herds):
            conn.send("snapshot")
            if not conn.poll(30.0):
                raise RuntimeError(f"herd child {c} snapshot timed out")
            for i, snap in enumerate(conn.recv()):
                snap["primary"] = self.herd_primaries[c][i]
                out.append(snap)
        return out

    def stop_herd(self) -> List[dict]:
        out: List[dict] = []
        for c, (conn, proc) in enumerate(self.herds):
            try:
                conn.send("stop")
                if conn.poll(15.0):
                    for i, snap in enumerate(conn.recv()):
                        snap["primary"] = self.herd_primaries[c][i]
                        out.append(snap)
            except (BrokenPipeError, EOFError, OSError):
                pass
            proc.join(timeout=5.0)
            if proc.is_alive():
                proc.terminate()
        self.herds = []
        self.herd_primaries = []
        return out

    # -- teardown -----------------------------------------------------
    def stop(self) -> None:
        self.stop_herd()
        for entry in self.replicas:
            if entry is None:
                continue
            conn, proc = entry
            if proc.is_alive():
                try:
                    conn.send("stop")
                    if conn.poll(5.0):
                        conn.recv()
                except (BrokenPipeError, EOFError, OSError):
                    pass
            proc.join(timeout=5.0)
            if proc.is_alive():
                proc.terminate()
        self.replicas = []
        if self.owner is not None:
            conn, proc = self.owner
            if proc.is_alive():
                try:
                    conn.send("stop")
                    if conn.poll(5.0):
                        conn.recv()
                except (BrokenPipeError, EOFError, OSError):
                    pass
            proc.join(timeout=5.0)
            if proc.is_alive():
                proc.terminate()
            self.owner = None
        shutil.rmtree(self.wal_root, ignore_errors=True)


# ---------------------------------------------------------------------------
# the writer (parent side — writes always hit the owner)


def _run_writer(client, creates: int, qps: float, seed: int,
                namespaces: int = 8, delete_frac: float = 0.2,
                offset: int = 0, live: Optional[list] = None) -> dict:
    """Paced open-loop create/delete stream. Seeded, and pacing never
    changes WHICH operations run, so every arm of the bench commits an
    identical op sequence → identical final truth and RVs (the
    differential-arm contract)."""
    from kubernetes_tpu_torch.harness.burst import make_burst_pods

    rng = random.Random(seed * 7919 + 11)
    ns_names = [f"herd-{i}" for i in range(namespaces)]
    pods = make_burst_pods(
        creates, cpu_milli=100, memory="64Mi",
        name_prefix=f"wh{seed}-", uid_prefix=f"whu{seed}-",
        offset=offset, namespaces=ns_names)
    live = live if live is not None else []
    deletes = 0
    ops = 0
    t0 = time.monotonic()
    for pod in pods:
        target = t0 + ops / qps
        now = time.monotonic()
        if target > now:
            time.sleep(target - now)
        client.create_pod(pod)
        ops += 1
        live.append((pod.namespace, pod.metadata.name))
        if len(live) > 20 and rng.random() < delete_frac:
            ns, name = live.pop(rng.randrange(len(live)))
            client.delete_pod(ns, name)
            deletes += 1
            ops += 1
    wall = max(time.monotonic() - t0, 1e-6)
    return {"creates": creates, "deletes": deletes,
            "events": creates + deletes, "wall_s": round(wall, 3),
            "offered_qps": qps,
            "achieved_qps": round((creates + deletes) / wall, 1)}


def _aggregate(snaps: List[dict], truth_hash: str) -> dict:
    agg = {
        "informers": len(snaps),
        "delivered_total": sum(s["delivered"] for s in snaps),
        "dup_suppressed": sum(s["dup_suppressed"] for s in snaps),
        "relists": sum(s["relists"] for s in snaps),
        "reroutes": sum(s["reroutes"] for s in snaps),
        "errors": sum(s["errors"] for s in snaps),
        "unconverged": sum(1 for s in snaps if s["hash"] != truth_hash),
    }
    agg["lost_events"] = agg["unconverged"]
    return agg


def _poll_converged(fleet: _ReadTierFleet, truth_hash: str,
                    deadline: float) -> None:
    while time.monotonic() < deadline:
        snaps = fleet.herd_snapshots()
        if all(s["hash"] == truth_hash for s in snaps):
            return
        time.sleep(0.1)


# ---------------------------------------------------------------------------
# the row's arms


def _run_watchherd_arm(seed: int, replicas: int, informers: int,
                       herd_children: int, creates: int, qps: float,
                       nodes: int, lag_budget_s: float,
                       wait_timeout: float,
                       progress: Optional[Callable]) -> dict:
    from kubernetes_tpu_torch.kubemark import HollowFleet

    fleet = _ReadTierFleet(progress=progress)
    client = None
    hollow = None
    try:
        owner_url = fleet.start_owner()
        client = RestClusterClient(owner_url)
        if nodes:
            hollow = HollowFleet(client, interval=5.0)
            hollow.register(nodes, chunk=500)
            hollow.start()
        replica_reads = 0
        if replicas:
            fleet.start_replicas(replicas, lag_budget_s=lag_budget_s)
            fleet.advertise()
            # the advertised path end-to-end: the client discovers the
            # replica set through the topology doc and its next read
            # must ride a replica, not the owner
            client.refresh_topology()
            client.list_pods()
            replica_reads = client.replica_reads
        fleet.start_herd(informers, herd_children)
        synced = fleet.wait_synced(informers,
                                   timeout=min(60.0, wait_timeout))
        if progress:
            progress(f"[watchherd] R={replicas}: {synced}/{informers} "
                     f"informers synced, writing {creates} pods")
        cpu0 = fleet.owner_counts()["cpu_s"]
        t0 = time.monotonic()
        wres = _run_writer(client, creates, qps, seed)
        truth = fleet.owner_counts()
        truth_hash = _state_hash(truth["pods"])
        _poll_converged(fleet, truth_hash,
                        t0 + min(wait_timeout, wres["wall_s"] + 120.0))
        converged_wall = time.monotonic() - t0
        # the owner's CPU spend over the whole window, write start to
        # herd convergence — the scale-out denominator: on R=0 it
        # includes every watch-frame send to every informer; on R>0
        # only the writes, the WAL, and one subscription copy per
        # replica (the unreplicatable partition owner is what the read
        # tier exists to offload)
        owner_cpu_s = fleet.owner_counts()["cpu_s"] - cpu0
        rstats = fleet.replica_stats()
        snaps = fleet.stop_herd()
        agg = _aggregate(snaps, truth_hash)
        lag_p99 = max((s.get("lag_p99_ms") or 0.0 for s in rstats),
                      default=0.0)
        res = {
            "replicas": replicas,
            "streams": informers + len(rstats),
            "synced": synced,
            "writer": wres,
            "truth_rv": truth["rv"],
            "truth_objects": len(truth["pods"]),
            "state_hash": truth_hash,
            "replica_reads": replica_reads,
            "convergence_wall_s": round(converged_wall, 3),
            "fanout_events_per_s": round(
                agg["delivered_total"] / max(converged_wall, 1e-6), 1),
            "owner_cpu_s": round(owner_cpu_s, 3),
            "fanout_per_owner_cpu_s": round(
                agg["delivered_total"] / max(owner_cpu_s, 1e-6), 1),
            "replication_lag_p99_ms": lag_p99,
            "fences": sum(int(s.get("fences") or 0) for s in rstats),
            "resumes": sum(int(s.get("resumes") or 0) for s in rstats),
            "reseeds": sum(int(s.get("reseeds") or 0) for s in rstats),
            "replica_stats": rstats,
        }
        res.update(agg)
        return res
    finally:
        if hollow is not None:
            hollow.stop()
        fleet.stop()


def _arm_invariants(res: dict, lag_budget_s: float) -> Tuple[bool, str]:
    why = []
    if res["unconverged"]:
        why.append(f"{res['unconverged']} informers never converged")
    if res["dup_suppressed"]:
        why.append(f"{res['dup_suppressed']} duplicate frames on "
                   "steady streams")
    if res["relists"]:
        why.append(f"{res['relists']} relists with no process killed")
    if res["fences"]:
        why.append(f"{res['fences']} fences inside the lag budget")
    if res["replicas"] and res["replica_reads"] < 1:
        why.append("no read rode a replica after the advertisement")
    if res["replication_lag_p99_ms"] > lag_budget_s * 1000:
        why.append(f"replication lag p99 "
                   f"{res['replication_lag_p99_ms']}ms over budget")
    return (not why), "; ".join(why)


def _readtier_diag(res: dict) -> None:
    import sys

    from kubernetes_tpu_torch.harness import diagfmt

    seg = diagfmt.format_readtier({
        "replicas": res.get("replicas", 0),
        "streams": res.get("streams", 0),
        "lag_p99_ms": res.get("replication_lag_p99_ms", 0.0),
        "fenced": res.get("fences", 0),
        "relists": res.get("relists", 0),
    })
    if seg:
        print(diagfmt.format_diag([seg]), file=sys.stderr, flush=True)


def _arm_row(res: dict, seed: int, creates: int, qps: float,
             lag_budget_s: float) -> dict:
    ok, why = _arm_invariants(res, lag_budget_s)
    wres = res["writer"]
    slo_ok = res["replication_lag_p99_ms"] <= lag_budget_s * 1000
    row = {
        "metric": (f"watchherd[{res['informers']} informers R="
                   f"{res['replicas']}, {wres['events']} events "
                   f"open-loop {qps:.0f}/s seed={seed}, REST fabric]"),
        "value": res["fanout_events_per_s"],
        "unit": "events/s",
        "informers": res["informers"],
        "replicas": res["replicas"],
        "streams": res["streams"],
        "events_committed": wres["events"],
        "delivered_total": res["delivered_total"],
        "lost_events": res["lost_events"],
        "unconverged_informers": res["unconverged"],
        "dup_suppressed": res["dup_suppressed"],
        "relists": res["relists"],
        "reroutes": res["reroutes"],
        "replica_reads": res["replica_reads"],
        "write_qps_offered": wres["offered_qps"],
        "write_qps_achieved": wres["achieved_qps"],
        "convergence_wall_s": res["convergence_wall_s"],
        "owner_cpu_s": res["owner_cpu_s"],
        "fanout_per_owner_cpu_s": res["fanout_per_owner_cpu_s"],
        "replication_lag_p99_ms": res["replication_lag_p99_ms"],
        "lag_budget_ms": round(lag_budget_s * 1000, 1),
        "fences": res["fences"],
        "state_hash": res["state_hash"],
        "truth_rv": res["truth_rv"],
        "invariants_ok": ok,
        "invariants": {"failed": why} if why else {},
        "freshness": {
            "replication_lag_p99_ms": res["replication_lag_p99_ms"],
            "slo": {"replication_lag":
                    "ok" if slo_ok else "violated"},
        },
    }
    return row


def run_watchherd_row(
    informers: int = 320,
    creates: int = 240,
    qps: float = 12.0,
    seed: int = 16,
    *,
    replica_arms: Sequence[int] = (0, 1, 4),
    herd_children: int = 4,
    nodes: int = 100,
    lag_budget_s: float = DEFAULT_LAG_BUDGET_S,
    wait_timeout: float = 600.0,
    progress: Optional[Callable[[str], None]] = None,
) -> List[dict]:
    """The watch-herd rows: one arm a replica count over the same seeded
    operations (the arm without replicas is the differential control), a
    scaling row, and the replica-kill cell.

    The defaults are sized to the bench host, upgrade-row style: 320
    informers is ≥10× the widest stream count any earlier committed
    row carried, and at that width the herd saturates the host — so
    the write rate is OPEN-LOOP at a rate every arm can sustain (the
    flat-write gate compares achieved rates; an offered rate beyond
    the saturated host's write capacity would measure scheduler
    starvation of the injector, not the read tier). Scale ``qps`` and
    ``creates`` up on hardware with cores to spare; the invariants
    and the per-owner-cpu scaling metric are rate-independent."""
    rows: List[dict] = []
    arms: Dict[int, dict] = {}
    for replicas in replica_arms:
        res = _run_watchherd_arm(
            seed, replicas, informers, herd_children, creates, qps,
            nodes, lag_budget_s, wait_timeout, progress)
        arms[replicas] = res
        rows.append(_arm_row(res, seed, creates, qps, lag_budget_s))
        _readtier_diag(res)
        if progress:
            progress(f"[watchherd] R={replicas}: "
                     f"{res['fanout_events_per_s']:.0f} ev/s fan-out, "
                     f"write {res['writer']['achieved_qps']:.0f}/s, "
                     f"lost {res['lost_events']}, "
                     f"lag p99 {res['replication_lag_p99_ms']}ms")
    base = arms.get(replica_arms[0]) or next(iter(arms.values()))
    top_r = max(replica_arms)
    top = arms[top_r]
    # Read scaling is judged on fan-out per OWNER CPU-second, not on
    # fleet wall-clock: the bench host time-shares every process on
    # the same cores, so wall-clock aggregate throughput measures the
    # host, not the architecture. What the read tier scales is how
    # many delivered events one owner CPU-second buys — on R=0 the
    # owner pays for every copy to every informer; on R=4 it pays for
    # four subscription copies and the replicas fan out the rest. On a
    # fleet with real per-process cores this IS wall-clock scaling;
    # both rates are committed side by side so the row hides nothing.
    scaling = (top["fanout_per_owner_cpu_s"] /
               max(base["fanout_per_owner_cpu_s"], 1e-6))
    wall_scaling = (top["fanout_events_per_s"] /
                    max(base["fanout_events_per_s"], 1e-6))
    write_ratio = (top["writer"]["achieved_qps"] /
                   max(base["writer"]["achieved_qps"], 1e-6))
    hashes = {r: a["state_hash"] for r, a in arms.items()}
    differential_match = len(set(hashes.values())) == 1
    rows.append({
        "metric": (f"watchherd_scaling[R={top_r} vs R="
                   f"{replica_arms[0]}, {informers} informers "
                   f"seed={seed}, per owner-cpu-second]"),
        "value": round(scaling, 2),
        "unit": "x",
        "baseline_events_per_owner_cpu_s":
            base["fanout_per_owner_cpu_s"],
        "scaled_events_per_owner_cpu_s":
            top["fanout_per_owner_cpu_s"],
        "baseline_events_per_s": base["fanout_events_per_s"],
        "scaled_events_per_s": top["fanout_events_per_s"],
        "wall_clock_scaling_x": round(wall_scaling, 2),
        "read_scaling_x": round(scaling, 2),
        "read_scaling_floor_x": READ_SCALING_FLOOR_X,
        "write_ratio": round(write_ratio, 3),
        "write_flat_ok": write_ratio >= 1.0 - WRITE_FLAT_TOLERANCE,
        "differential_match": differential_match,
        "state_hashes": {str(k): v for k, v in hashes.items()},
        "invariants_ok": (scaling >= READ_SCALING_FLOOR_X
                          and write_ratio >= 1.0 - WRITE_FLAT_TOLERANCE
                          and differential_match),
    })
    if progress:
        progress(f"[watchherd] read scaling {scaling:.2f}x at "
                 f"R={top_r}, write ratio {write_ratio:.2f}, "
                 f"differential "
                 f"{'match' if differential_match else 'MISMATCH'}")
    cell = run_readtier_cell(seed, scenario="replica_kill",
                             wait_timeout=wait_timeout,
                             progress=progress)
    rows.append(_cell_row(cell))
    return rows


def _cell_row(cell: dict) -> dict:
    return {
        "metric": (f"watchherd_cell[{cell['profile']} "
                   f"seed={cell['seed']}]"),
        "value": 1 if cell["ok"] else 0,
        "unit": "ok",
        **{k: v for k, v in cell.items()
           if k not in ("replica_stats",)},
        "invariants_ok": cell["ok"],
        "invariants": ({"failed": cell["failure"]}
                       if cell["failure"] else {}),
    }


# ---------------------------------------------------------------------------
# chaos cells


def run_readtier_cell(
    seed: int,
    *,
    scenario: str = "replica_kill",
    informers: int = 48,
    creates: int = 240,
    qps: float = 120.0,
    replicas: int = 2,
    wait_timeout: float = 240.0,
    progress: Optional[Callable] = None,
) -> dict:
    """One (scenario × seed) chaos cell over the spawned fleet: fault
    mid-herd, then judge confinement and loss at quiesce."""
    if scenario not in READTIER_SCENARIOS:
        raise ValueError(f"unknown readtier scenario {scenario!r} "
                         f"(have: {', '.join(READTIER_SCENARIOS)})")
    lag_budget_s = 0.15 if scenario == "lag_fence" else \
        DEFAULT_LAG_BUDGET_S
    # lag_fence arms replica r1 with a per-event apply stall that must
    # blow the 150ms budget under the write stream
    delays = (0.0, 0.06) if scenario == "lag_fence" else ()
    fleet = _ReadTierFleet(progress=progress)
    client = None
    try:
        owner_url = fleet.start_owner()
        client = RestClusterClient(owner_url)
        fleet.start_replicas(replicas, lag_budget_s=lag_budget_s,
                             apply_delays=delays)
        fleet.advertise()
        fleet.start_herd(informers, children=2)
        fleet.wait_synced(informers, timeout=60.0)
        live: list = []
        w1 = _run_writer(client, creates // 2, qps, seed, live=live)
        faulted = None
        if scenario == "replica_kill":
            faulted = 0
            fleet.kill_replica(0)
        elif scenario == "owner_restart":
            fleet.kill_owner()
            fleet.restart_owner()
        w2 = _run_writer(client, creates - creates // 2, qps,
                         seed + 1, offset=creates // 2, live=live)
        if scenario == "lag_fence":
            faulted = 1
        truth = fleet.owner_counts()
        truth_hash = _state_hash(truth["pods"])
        deadline = time.monotonic() + min(wait_timeout, 120.0)
        _poll_converged(fleet, truth_hash, deadline)
        rstats = fleet.replica_stats()
        snaps = fleet.stop_herd()
        agg = _aggregate(snaps, truth_hash)
        relists_on_faulted = sum(
            s["relists"] for s in snaps if s["primary"] == faulted)
        relists_beyond = agg["relists"] - relists_on_faulted
        fences = sum(int(s.get("fences") or 0) for s in rstats)
        resumes = sum(int(s.get("resumes") or 0) for s in rstats)
        reseeds = sum(int(s.get("reseeds") or 0) for s in rstats)
        why = []
        if agg["unconverged"]:
            why.append(f"{agg['unconverged']} informers lost events")
        if scenario == "replica_kill":
            if relists_beyond:
                why.append(f"{relists_beyond} relists beyond the "
                           "killed replica")
            if relists_on_faulted < 1:
                why.append("killed replica's informers never relisted")
        elif scenario == "owner_restart":
            if agg["relists"]:
                why.append(f"{agg['relists']} relists across an owner "
                           "restart (replica streams must hold)")
            if resumes < 1:
                why.append("no replica resumed its subscription")
            if reseeds:
                why.append(f"{reseeds} full reseeds (WAL resume "
                           "window lost)")
        elif scenario == "lag_fence":
            if fences < 1:
                why.append("lagging replica never fenced")
            if relists_beyond:
                why.append(f"{relists_beyond} relists beyond the "
                           "fenced replica")
        ok = not why
        cell = {
            "seed": seed,
            "profile": scenario,
            "ok": ok,
            "failure": "; ".join(why),
            "informers": informers,
            "replicas": replicas,
            "events_committed": w1["events"] + w2["events"],
            "delivered_total": agg["delivered_total"],
            "lost_events": agg["lost_events"],
            "dup_suppressed": agg["dup_suppressed"],
            "relists": agg["relists"],
            "relists_on_faulted": relists_on_faulted,
            "relists_beyond_faulted": relists_beyond,
            "reroutes": agg["reroutes"],
            "fences": fences,
            "resumes": resumes,
            "reseeds": reseeds,
            "state_hash": truth_hash,
            "replica_stats": rstats,
        }
        _readtier_diag({
            "replicas": replicas, "streams": informers,
            "replication_lag_p99_ms": max(
                (s.get("lag_p99_ms") or 0.0 for s in rstats),
                default=0.0),
            "fences": fences, "relists": agg["relists"],
        })
        if progress:
            progress(f"[readtier] {scenario} seed={seed}: "
                     f"{'OK' if ok else 'FAILED: ' + cell['failure']}")
        return cell
    finally:
        fleet.stop()


def run_chaos_readtier(seed: int, pods: int = 240,
                       wait_timeout: float = 240.0,
                       progress: Optional[Callable] = None,
                       scenario: str = "replica_kill") -> Dict:
    """One (scenario x seed) chaos cell at ``pods`` creates (at least
    80)."""
    return run_readtier_cell(seed, scenario=scenario,
                             creates=max(80, int(pods)),
                             wait_timeout=wait_timeout,
                             progress=progress)


# ---------------------------------------------------------------------------
# the in-process mini cell


def run_readtier_mini_cell(
    informers: int = 10,
    creates: int = 120,
    qps: float = 400.0,
    seed: int = 7,
    progress: Optional[Callable[[str], None]] = None,
) -> Dict:
    """CI-fast read-tier cell, all in-process: one owner apiserver, two
    ``ReadReplica``s, a mini informer herd pinned across them, a live
    writer — and one replica HARD-KILLED mid-stream. Asserted by the
    caller: every informer ≡ owner truth at quiesce, zero lost and
    zero double-applied events, relists confined to the killed
    replica's informers, and the surviving replica's store identical
    to the owner's."""
    from kubernetes_tpu_torch.apiserver.readtier import ReadReplica
    from kubernetes_tpu_torch.apiserver.rest import APIServer
    from kubernetes_tpu_torch.apiserver.store import ClusterStore

    store = ClusterStore()
    owner = APIServer(store=store).start()
    reps = [ReadReplica(owner.url, replica_id=f"mini-r{i}")
            for i in range(2)]
    client = None
    stop = threading.Event()
    herd: List[_MiniInformer] = []
    try:
        for rep in reps:
            rep.start(seed_timeout=10.0)
        urls = [rep.url for rep in reps]
        primaries = []
        for i in range(informers):
            primary = i % 2
            eps = [urls[primary], urls[1 - primary], owner.url]
            inf = _MiniInformer(i, eps, stop)
            herd.append(inf)
            primaries.append(primary)
            inf.start()
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline and \
                not all(i.synced.is_set() for i in herd):
            time.sleep(0.05)
        client = RestClusterClient(owner.url)
        live: list = []
        _run_writer(client, creates // 2, qps, seed, live=live)
        reps[0].kill()  # hard kill: live sockets severed mid-stream
        _run_writer(client, creates - creates // 2, qps, seed + 1,
                    offset=creates // 2, live=live)
        truth = sorted((p.namespace, p.metadata.name,
                        int(p.metadata.resource_version))
                       for p in store.list_pods())
        truth_hash = _state_hash(truth)
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            snaps = [i.snapshot() for i in herd]
            if all(s["hash"] == truth_hash for s in snaps):
                break
            time.sleep(0.1)
        snaps = [i.snapshot() for i in herd]
        for s, primary in zip(snaps, primaries):
            s["primary"] = primary
        agg = _aggregate(snaps, truth_hash)
        # the surviving replica must converge to owner truth too
        deadline = time.monotonic() + 10.0
        replica_truth: list = []
        while time.monotonic() < deadline:
            replica_truth = sorted(
                (p.namespace, p.metadata.name,
                 int(p.metadata.resource_version))
                for p in reps[1].store.list_pods())
            if replica_truth == truth:
                break
            time.sleep(0.05)
        relists_on_killed = sum(
            s["relists"] for s in snaps if s["primary"] == 0)
        agg.update({
            "truth_objects": len(truth),
            "state_hash": truth_hash,
            "replica_truth_match": replica_truth == truth,
            "relists_on_killed": relists_on_killed,
            "relists_beyond_killed": agg["relists"] - relists_on_killed,
            "killed_informers": sum(1 for p in primaries if p == 0),
            "survivor_stats": reps[1].stats(),
        })
        if progress:
            progress(f"[readtier-mini] lost={agg['lost_events']} "
                     f"relists={agg['relists']} "
                     f"(killed={relists_on_killed})")
        return agg
    finally:
        stop.set()
        for inf in herd:
            inf.sever()
        for inf in herd:
            inf.join(timeout=2.0)
        for rep in reps:
            try:
                rep.stop()
            except Exception:  # noqa: BLE001
                pass
        owner.shutdown_server()
