"""Durable storage behind the ClusterStore: append-only WAL + snapshots.

Every watch-visible mutation (the store dispatches one event per
mutation, in commit order, under the store lock) is appended to a
JSON-lines log; a snapshot of the full object space is cut when the log
grows past ``snapshot_every`` entries; and ``restore_store`` rebuilds a
ClusterStore from snapshot + log replay, preserving object identity,
resource versions and the revision counter, so watches resumed against
the restored store keep etcd's semantics. The log's lines are the JAX
package's, so either package restores the other's log.

Usage::

    store = ClusterStore()
    wal = attach_wal(store, "/var/lib/ktpu")     # from then on: durable
    ...
    # after a crash:
    store2 = restore_store("/var/lib/ktpu")

Two writers, as in the JAX package (``attach_wal(async_serialize=)``):

- synchronous (the default): each event is serialized and appended in
  the store's dispatch, under the store lock, so a write is on disk
  before the store call returns and before its HTTP response is sent.
  A SIGKILL loses no acknowledged write (the reshard and upgrade
  children rely on it);
- asynchronous (``async_serialize=True``, the REST and replay rows): a
  writer thread serializes and appends, off the store lock, and a crash
  can lose the events still queued (the window ``drain`` closes).

Nothing is fsynced per append.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Optional

from kubernetes_tpu_torch.api.serialization import from_wire, to_wire
from kubernetes_tpu_torch.apiserver.store import DELETED, ClusterStore, Event

LOG_NAME = "wal.jsonl"
SNAP_NAME = "snapshot.json"
SNAP_TMP = "snapshot.json.tmp"


class WalHandle:
    """``async_serialize=False`` appends inline: the store dispatches each
    mutation batch synchronously under its lock, and the batch is on disk
    when the dispatch returns. ``async_serialize=True`` only enqueues the
    event there (the store hands watchers freshly-built objects that later
    mutations never touch, so holding a reference is snapshot-safe) and a
    writer thread serializes and appends in commit order, off the store
    lock: etcd's own shape, raft appends pipelined behind the apply loop.
    Lock order is store, then WAL, everywhere."""

    def __init__(self, store: ClusterStore, directory: str,
                 snapshot_every: int = 20000,
                 async_serialize: bool = False):
        self.store = store
        self.dir = directory
        self.snapshot_every = snapshot_every
        self.async_serialize = bool(async_serialize)
        os.makedirs(directory, exist_ok=True)
        self._log_path = os.path.join(directory, LOG_NAME)
        self._log = open(self._log_path, "a", encoding="utf-8")
        self._entries_since_snapshot = 0
        # guards the log file between the appender and ``snapshot``
        self._lock = threading.Lock()
        self._queue: "queue.Queue[Optional[Event]]" = queue.Queue()
        self._writer: Optional[threading.Thread] = None
        if self.async_serialize:
            self._writer = threading.Thread(
                target=self._writer_loop, daemon=True, name="wal-writer")
            self._writer.start()
        self._watch = store.watch(self._on_events)
        # the silent placement channel (a partition's slice moving in or
        # out): no watcher hears it, but a restore that missed it would
        # lose the slice or bring it back on the wrong partition
        self._silent_watch = store.watch_silent(self._on_events)

    # ------------------------------------------------------------------
    def _on_events(self, events) -> None:
        if self.async_serialize:
            for event in events:
                self._queue.put(event)
            return
        # inline: the dispatch holds the store lock, so a compaction
        # here keeps the store -> WAL order
        for event in events:
            self._append(event)
        if self._entries_since_snapshot >= self.snapshot_every:
            with self._lock:
                self._snapshot_locked()

    def _writer_loop(self) -> None:
        while True:
            event = self._queue.get()
            try:
                if event is None:
                    return
                try:
                    self._append(event)
                except Exception:   # noqa: BLE001 — a bad record must
                    pass            # not kill durability for all after
                if self._entries_since_snapshot >= self.snapshot_every:
                    try:
                        self.snapshot()
                    except Exception:   # noqa: BLE001
                        pass
            finally:
                self._queue.task_done()

    def _line_for(self, event: Event) -> str:
        obj = event.obj
        rv = getattr(obj.metadata, "resource_version", "") or "0"
        if event.type == DELETED:
            line = {
                "t": "DEL", "k": event.kind, "rv": int(rv),
                "ns": getattr(obj.metadata, "namespace", ""),
                "n": obj.metadata.name,
            }
        else:
            line = {"t": "PUT", "k": event.kind, "rv": int(rv),
                    "o": to_wire(obj)}
        return json.dumps(line)

    def _append(self, event: Event) -> None:
        line = self._line_for(event)
        with self._lock:
            self._log.write(line + "\n")
            self._log.flush()
            self._entries_since_snapshot += 1

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until every event enqueued so far is on disk (appended
        and flushed; at once for the inline writer). False when
        ``timeout`` ran out first."""
        deadline = time.monotonic() + timeout
        done = self._queue.all_tasks_done
        with done:
            while self._queue.unfinished_tasks:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                done.wait(left)
        return True

    # ------------------------------------------------------------------
    def snapshot(self) -> None:
        """Cut a snapshot now and truncate the log (etcd compaction): the
        upgrade row's quiesce, so a standby restores one snapshot rather
        than replaying the log. Under the store lock no event is
        dispatched; events the asynchronous writer still holds are in the
        snapshot already and land in the fresh log after it, where
        restore's per-object version guard skips them."""
        with self.store._lock:
            with self._lock:
                self._snapshot_locked()

    def _snapshot_locked(self) -> None:
        objects = []
        rv = self.store._rv
        for kind in self.store.known_kinds():
            table, _ = self.store._kind_entry(kind)
            for obj in table.values():
                objects.append([kind, to_wire(obj)])
        tmp = os.path.join(self.dir, SNAP_TMP)
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"rv": rv, "objects": objects}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.dir, SNAP_NAME))
        self._log.close()
        self._log = open(self._log_path, "w", encoding="utf-8")
        self._entries_since_snapshot = 0

    def close(self) -> None:
        """Stop logging, write out what is queued, close the log."""
        self._watch.stop()
        self._silent_watch.stop()
        if self._writer is not None:
            self.drain()
            self._queue.put(None)
            self._writer.join(timeout=5.0)
        with self._lock:
            self._log.close()


def attach_wal(store: ClusterStore, directory: str,
               snapshot_every: int = 20000,
               async_serialize: bool = False,
               preserve_log: bool = False) -> WalHandle:
    """Make ``store`` durable: all subsequent mutations are logged, inline
    unless ``async_serialize``. Cuts an initial snapshot so pre-existing
    state is captured too; the watch is opened and the snapshot cut under
    the store lock, so no mutation falls between them and the writer's
    queue is empty.

    ``preserve_log=True`` (a restart after ``restore_store``): no initial
    snapshot, which would truncate the log; the log's torn tail, if the
    crash left one, is cut back to its last whole line and the log is
    appended to. A read replica resuming its subscription across the
    owner's restart replays the missed window from this log
    (``wal_events_since``)."""
    if preserve_log:
        _repair_log_tail(os.path.join(directory, LOG_NAME))
        return WalHandle(store, directory, snapshot_every=snapshot_every,
                         async_serialize=async_serialize)
    with store._lock:
        handle = WalHandle(store, directory, snapshot_every=snapshot_every,
                           async_serialize=async_serialize)
        with handle._lock:
            handle._snapshot_locked()
    return handle


def _repair_log_tail(path: str) -> None:
    """Cut a torn final line (a crash mid-append) so appends start on a
    line of their own: restore stops at the torn line, and a record
    appended to it would be lost with it."""
    if not os.path.exists(path):
        return
    with open(path, "rb") as f:
        data = f.read()
    if not data or data.endswith(b"\n"):
        return
    cut = data.rfind(b"\n")
    os.truncate(path, cut + 1 if cut >= 0 else 0)


def wal_events_since(directory: str, cursor: int):
    """Parsed WAL entries with rv > ``cursor``: the resume source for a
    reader whose window the in-memory watch cache cannot cover (a
    restarted server starts with an empty cache). Returns ``(covered, entries)``: ``covered`` is False when
    compaction may have swallowed part of the window (a snapshot newer
    than the cursor with no log line at-or-below it) — the caller must
    answer 410 and the replica reseeds. Entries keep the on-disk shape
    ({"t": "PUT"/"DEL", "k": kind, "rv": rv, ...}); duplicates below
    the reader's per-object guard are harmless by contract."""
    snap_rv = 0
    snap_path = os.path.join(directory, SNAP_NAME)
    if os.path.exists(snap_path):
        try:
            with open(snap_path, encoding="utf-8") as f:
                snap_rv = int((json.load(f) or {}).get("rv") or 0)
        except (json.JSONDecodeError, OSError, ValueError):
            return False, []
    entries = []
    min_rv = None
    log_path = os.path.join(directory, LOG_NAME)
    if os.path.exists(log_path):
        with open(log_path, encoding="utf-8") as f:
            for raw in f:
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    line = json.loads(raw)
                except json.JSONDecodeError:
                    break   # torn tail write from a crash: stop here
                line_rv = int(line.get("rv") or 0)
                if min_rv is None or line_rv < min_rv:
                    min_rv = line_rv
                if line_rv > cursor:
                    entries.append(line)
    covered = cursor >= snap_rv \
        or (min_rv is not None and min_rv <= cursor + 1)
    return covered, entries


def restore_store(directory: str,
                  store: Optional[ClusterStore] = None) -> ClusterStore:
    """Rebuild a ClusterStore from snapshot + WAL replay (crash
    recovery: the store process restarts; clients re-list-and-watch).
    Resource versions and the revision counter survive, so a resumed
    watch sees a monotonic history. A kind the port does not serve
    raises ``TypeError``."""
    store = store if store is not None else ClusterStore()
    max_rv = 0
    snap_path = os.path.join(directory, SNAP_NAME)
    if os.path.exists(snap_path):
        with open(snap_path, encoding="utf-8") as f:
            snap = json.load(f)
        max_rv = int(snap.get("rv") or 0)
        with store._lock:
            for kind, wire in snap.get("objects", ()):
                obj = from_wire(wire, kind)
                table, key = store._table_key(
                    kind, obj.metadata.namespace, obj.metadata.name
                )
                table[key] = obj
    log_path = os.path.join(directory, LOG_NAME)
    if os.path.exists(log_path):
        with open(log_path, encoding="utf-8") as f:
            for raw in f:
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    line = json.loads(raw)
                except json.JSONDecodeError:
                    break  # torn tail write from the crash: stop replay
                line_rv = int(line.get("rv") or 0)
                max_rv = max(max_rv, line_rv)
                kind = line["k"]

                def newer_exists(table, key) -> bool:
                    # per-object rv guard: the async writer may append
                    # (after a compaction it didn't wait for) entries
                    # the snapshot already contains — replaying them
                    # must never regress a newer object
                    cur = table.get(key)
                    if cur is None:
                        return False
                    cur_rv = int(getattr(cur.metadata, "resource_version",
                                         "") or 0)
                    return cur_rv > line_rv
                if line["t"] == "DEL":
                    try:
                        table, key = store._table_key(
                            kind, line.get("ns", ""), line["n"]
                        )
                    except KeyError:
                        continue  # a kind no object was stored of
                    if newer_exists(table, key):
                        continue
                    table.pop(key, None)
                else:
                    obj = from_wire(line["o"], kind)
                    table, key = store._table_key(
                        kind, obj.metadata.namespace, obj.metadata.name
                    )
                    if newer_exists(table, key):
                        continue
                    table[key] = obj
    with store._lock:
        store._rv = max(store._rv, max_rv)
        store.recount_locked()
    return store
