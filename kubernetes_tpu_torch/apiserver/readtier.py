"""The read tier: watch replicas of a partition that scale its read fan-out.

Every kubelet, controller and dashboard is a list and watch client, and
one partition's apiserver serves both its writes and that whole fan-out.
A read replica takes the fan-out off it:

- ``ReplicationClient`` follows the owner's commit stream
  (``/api/v1/subscription``, ``apiserver/rest.py``). It seeds from
  ``?snapshot=1`` through ``ClusterStore.adopt_objects`` (versions kept,
  no watch event: a replica's clients list first and must not see a
  phantom ADDED storm), then applies the live stream through
  ``ClusterStore.apply_replicated``, which keeps versions and drops what
  the mirror already holds, so a resume's overlap collapses. Its cursor
  is the newest applied version: a dropped connection resumes from it,
  and only a 410 (the owner's watch cache and WAL both compacted past
  the cursor) makes it seed again.
- ``FenceStateMachine``: the staleness contract. Each applied frame's
  lag (now minus its commit time) feeds the replica's
  ``replication_lag_seconds`` series and this hysteresis: ``trip_after``
  samples in a row over the budget fence the replica (its server answers
  reads 503 with ``X-Replica-Fenced`` and closes its watch streams, its
  clients read elsewhere and relist on this replica only);
  ``clear_after`` samples in a row under half the budget unfence it.
- ``ReadReplica``: a mirror store, a ``read_only`` ``APIServer`` serving
  lists from its own caches and watches from its own dispatch, and the
  ``ReplicationClient`` that feeds it and sets the server's fence.
  ``advertise_replicas`` puts replica URLs into the partition's
  ``PartitionTopology`` (``replicas``), through which
  ``RestClusterClient`` sends reads to them while writes go to the owner.

Losing a replica costs its clients one relist; an owner restart replays
the missed window from the owner's WAL (``attach_wal(...,
preserve_log=True)``), so live replicas resume from their cursors and
seed nothing (``harness/watchherd.py`` measures both).
"""

from __future__ import annotations

import json
import socket
import threading
import time
from http.client import HTTPConnection
from typing import Any, Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.serialization import from_wire
from kubernetes_tpu_torch.apiserver.rest import APIServer
from kubernetes_tpu_torch.apiserver.store import (
    MODIFIED,
    ClusterStore,
    Event,
)
from kubernetes_tpu_torch.metrics.freshness_metrics import freshness_metrics

__all__ = [
    "FenceStateMachine",
    "ReplicationClient",
    "ReadReplica",
    "advertise_replicas",
]

# a replica more than half a second behind its owner for 3 batches in a
# row serves history, not state; unfencing takes 5 batches under half the
# budget, so a replica at the budget's edge does not flap its clients
DEFAULT_LAG_BUDGET_S = 0.5
FENCE_TRIP_AFTER = 3
FENCE_CLEAR_AFTER = 5


class FenceStateMachine:
    """Hysteresis over replication-lag samples. ``observe(lag_s)``
    returns True when the replica fences, False when it unfences, None
    otherwise. Fencing takes ``trip_after`` consecutive samples over
    ``lag_budget_s``; unfencing ``clear_after`` consecutive samples at or
    under half of it."""

    def __init__(self, lag_budget_s: float = DEFAULT_LAG_BUDGET_S,
                 trip_after: int = FENCE_TRIP_AFTER,
                 clear_after: int = FENCE_CLEAR_AFTER):
        self.lag_budget_s = float(lag_budget_s)
        self.trip_after = max(1, int(trip_after))
        self.clear_after = max(1, int(clear_after))
        self.fenced = False
        self.fences = 0          # fence transitions so far
        self._over = 0
        self._under = 0

    def observe(self, lag_s: float) -> Optional[bool]:
        if not self.fenced:
            if lag_s > self.lag_budget_s:
                self._over += 1
                if self._over >= self.trip_after:
                    self.fenced = True
                    self.fences += 1
                    self._under = 0
                    return True
            else:
                self._over = 0
            return None
        if lag_s <= self.lag_budget_s / 2.0:
            self._under += 1
            if self._under >= self.clear_after:
                self.fenced = False
                self._over = 0
                return False
        else:
            self._under = 0
        return None


def _parse_frame(line: bytes) -> Optional[Event]:
    """One subscription line as an Event for ``apply_replicated``. A live
    frame carries the whole object; a delete replayed from the WAL a key
    only, for which a metadata-only object is made up."""
    frame = json.loads(line)
    kind = frame.get("kind")
    rv = int(frame.get("rv") or 0)
    etype = frame.get("type") or MODIFIED
    ts = float(frame.get("commitTs") or 0.0)
    if frame.get("object") is not None:
        obj = from_wire(frame["object"], kind)
    elif frame.get("key") is not None:
        ns, name = frame["key"]
        obj = from_wire({"kind": kind, "metadata": {
            "namespace": ns or "", "name": name,
            "resourceVersion": str(rv)}}, kind)
    else:
        return None
    return Event(etype, kind, obj, ts=ts, origin="owner")


class ReplicationClient:
    """The owner's commit stream into a mirror store, with cursor resume.

    Seed: ``GET /api/v1/subscription?snapshot=1``, a leading ``{"rv":
    R}`` line and each kind's objects, adopted silently; the cursor
    starts at R. Stream: ``GET /api/v1/subscription?resourceVersion=
    <cursor>``, each frame applied through ``apply_replicated``; the
    cursor moves to the newest applied version. A dropped connection
    resumes from the cursor (``resumes``); a 410 seeds again
    (``reseeds``), the only path that costs the replica's clients a
    relist. A resume waits at most a quarter of the lag budget between
    attempts (the reference waits up to a second), so the window an
    owner's restart leaves is replayed within the budget. Each frame's
    lag feeds the replica's
    ``replication_lag_seconds`` series and the fence machine, whose
    transitions call ``fence_cb(fenced)``. ``apply_delay`` sleeps before
    each apply: real lag without touching the wire (the lag-fence
    cell)."""

    def __init__(self, owner_url: str, store: ClusterStore,
                 replica_id: str = "r0",
                 lag_budget_s: float = DEFAULT_LAG_BUDGET_S,
                 fence_cb: Optional[Callable[[bool], None]] = None,
                 apply_delay: float = 0.0,
                 token: str = ""):
        host_port = owner_url.rstrip("/").split("//", 1)[-1]
        host, _, port = host_port.partition(":")
        self._host, self._port = host, int(port or 80)
        self.store = store
        self.replica_id = replica_id
        self.fence = FenceStateMachine(lag_budget_s)
        self.fence_cb = fence_cb
        self.apply_delay = float(apply_delay)
        self.token = token
        self.cursor: Optional[int] = None
        self.events_applied = 0
        self.events_seen = 0
        self.resumes = 0
        self.reseeds = 0
        self.last_lag_s = 0.0
        self.max_lag_s = 0.0
        self.seeded = threading.Event()
        self._stop = threading.Event()
        self._conn: Optional[HTTPConnection] = None
        self._thread: Optional[threading.Thread] = None
        self._lag_hist = freshness_metrics().replication_lag_seconds

    # -- lifecycle ----------------------------------------------------
    def start(self) -> "ReplicationClient":
        self._thread = threading.Thread(
            target=self._run, name=f"replication-{self.replica_id}",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        conn = self._conn
        if conn is not None:
            # wake the blocked readline: shut the socket down (a close
            # would want the reader's lock)
            sock = getattr(conn, "sock", None)
            if sock is not None:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
            try:
                conn.close()
            except OSError:
                pass
        t = self._thread
        if t is not None:
            t.join(timeout=5)

    # -- wire ---------------------------------------------------------
    def _open(self, path: str):
        conn = HTTPConnection(self._host, self._port, timeout=30)
        headers = {}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        conn.request("GET", path, headers=headers)
        self._conn = conn
        return conn, conn.getresponse()

    def _seed(self) -> bool:
        try:
            conn, resp = self._open("/api/v1/subscription?snapshot=1")
        except OSError:
            return False
        try:
            if resp.status != 200:
                resp.read()
                return False
            head = resp.readline()
            if not head:
                return False
            rv0 = int(json.loads(head)["rv"])
            while True:
                line = resp.readline()
                if not line or line.strip() == b"":
                    break
                batch = json.loads(line)
                objs = [from_wire(w, batch["kind"])
                        for w in batch.get("objects") or ()]
                if objs:
                    self.store.adopt_objects(batch["kind"], objs)
        except (OSError, ValueError, KeyError, AttributeError):
            return False
        finally:
            try:
                conn.close()
            except Exception:  # noqa: BLE001 — a broken socket
                pass
            self._conn = None
        self.cursor = rv0
        self.seeded.set()
        return True

    def _observe_lag(self, ts: float) -> None:
        if ts <= 0:
            return
        lag = max(0.0, time.time() - ts)
        self.last_lag_s = lag
        self.max_lag_s = max(self.max_lag_s, lag)
        self._lag_hist.observe(lag, self.replica_id)
        flip = self.fence.observe(lag)
        if flip is not None and self.fence_cb is not None:
            self.fence_cb(flip)

    def _stream_once(self) -> str:
        """One subscription: 'gone' (410: seed again), 'retry' (the
        connection dropped: resume from the cursor) or 'stop'."""
        try:
            conn, resp = self._open(
                f"/api/v1/subscription?resourceVersion={self.cursor}")
        except OSError:
            return "retry"
        try:
            if resp.status == 410:
                resp.read()
                return "gone"
            if resp.status != 200:
                resp.read()
                return "retry"
            while not self._stop.is_set():
                line = resp.readline()
                if not line:
                    return "retry"
                line = line.strip()
                if not line:
                    continue
                self.events_seen += 1
                try:
                    e = _parse_frame(line)
                except (ValueError, KeyError, TypeError):
                    continue
                if e is None:
                    continue
                if self.apply_delay > 0:
                    time.sleep(self.apply_delay)
                applied = self.store.apply_replicated([e])
                self.events_applied += len(applied)
                rv = int(e.obj.metadata.resource_version or 0)
                if self.cursor is None or rv > self.cursor:
                    self.cursor = rv
                self._observe_lag(e.ts)
        except (OSError, ValueError, AttributeError):
            # a socket shut down mid-readline surfaces from http.client's
            # chunk decoder as ValueError or AttributeError too: resume
            return "retry"
        finally:
            try:
                conn.close()
            except Exception:  # noqa: BLE001 — a broken socket
                pass
            self._conn = None
        return "stop"

    def _run(self) -> None:
        backoff = 0.05
        while not self._stop.is_set():
            if self.cursor is None:
                if not self._seed():
                    self._stop.wait(backoff)
                    backoff = min(backoff * 2, 1.0)
                    continue
                backoff = 0.05
            outcome = self._stream_once()
            if outcome == "stop" or self._stop.is_set():
                return
            if outcome == "gone":
                # the owner compacted past the cursor: seed again, which
                # costs this replica's clients a relist
                self.reseeds += 1
                self.cursor = None
                self._stop.wait(backoff)
            else:
                self.resumes += 1
                # what the owner commits while this replica waits comes
                # back with the wait as its lag: a resume waits at most a
                # quarter of the budget, so an owner's restart does not
                # fence its replicas
                self._stop.wait(min(backoff, self.fence.lag_budget_s / 4))
            backoff = min(backoff * 2, 1.0)

    def stats(self) -> Dict[str, Any]:
        return {
            "replica": self.replica_id,
            "cursor": self.cursor,
            "events_seen": self.events_seen,
            "events_applied": self.events_applied,
            "resumes": self.resumes,
            "reseeds": self.reseeds,
            "fences": self.fence.fences,
            "fenced": self.fence.fenced,
            "last_lag_s": round(self.last_lag_s, 6),
            "max_lag_s": round(self.max_lag_s, 6),
        }


class ReadReplica:
    """One read replica: a mirror store, a read-only ``APIServer`` over it
    (no APF and no in-flight lanes: back-pressure belongs on the owner's
    write path) and the ``ReplicationClient`` that feeds it. The fence
    machine's transitions set and clear the server's ``fenced`` event."""

    def __init__(self, owner_url: str,
                 partition: Tuple[int, int] = (0, 1),
                 replica_id: str = "r0",
                 host: str = "127.0.0.1", port: int = 0,
                 lag_budget_s: float = DEFAULT_LAG_BUDGET_S,
                 apply_delay: float = 0.0,
                 tokens: Optional[Dict[str, str]] = None,
                 authorizer: Any = None,
                 token: str = ""):
        self.replica_id = replica_id
        self.store = ClusterStore()
        kwargs: Dict[str, Any] = dict(
            store=self.store, host=host, port=port,
            partition=tuple(partition), read_only=True,
            flow_control=None, max_readonly_inflight=None,
            max_mutating_inflight=None,
        )
        if tokens is not None:
            kwargs["tokens"] = tokens
        if authorizer is not None:
            kwargs["authorizer"] = authorizer
        self.server = APIServer(**kwargs)
        self.repl = ReplicationClient(
            owner_url, self.store, replica_id=replica_id,
            lag_budget_s=lag_budget_s, apply_delay=apply_delay,
            fence_cb=self._on_fence, token=token)

    def _on_fence(self, fenced: bool) -> None:
        if fenced:
            self.server.fenced.set()
        else:
            self.server.fenced.clear()

    # -- lifecycle ----------------------------------------------------
    def start(self, seed_timeout: float = 10.0) -> "ReadReplica":
        self.server.start()
        self.repl.start()
        # no read before the first seed: an empty mirror would answer
        # lists at version 0 and every informer would relist
        self.repl.seeded.wait(seed_timeout)
        return self

    def stop(self) -> None:
        self.repl.stop()
        self.server.shutdown_server()

    def kill(self) -> None:
        """A hard kill: stop serving and sever every live client
        connection, as a killed process drops its sockets, so pooled
        keep-alive clients see the failure."""
        self.repl.stop()
        self.server.shutdown_server()
        self.server.sever_connections()
        try:
            self.server.server_close()
        except OSError:
            pass

    @property
    def url(self) -> str:
        return self.server.url

    def stats(self) -> Dict[str, Any]:
        s = self.repl.stats()
        s["url"] = self.url
        s["store_rv"] = self.store.current_rv()
        return s


def advertise_replicas(topology, partition: int, urls: List[str]):
    """``topology`` with ``partition``'s replica URLs set (none: removed),
    its epoch bumped, so clients refresh and route reads to them."""
    replicas = dict(topology.replicas)
    if urls:
        replicas[int(partition)] = tuple(u.rstrip("/") for u in urls)
    else:
        replicas.pop(int(partition), None)
    return topology.evolve(replicas=replicas)
