"""The partitioned control plane: P store partitions behind one store API.

One ``ClusterStore`` puts every write through one lock, one watch fan-out
and, over REST, one server process. This module shards it:

- ``partition_for``: the one routing function (crc32, the same in every
  process). Pods shard by namespace, nodes by name; every other kind
  lives in partition 0, so the long tail of the API needs no fan-out.
- ``PartitionedStore``: P ``ClusterStore`` partitions, each with its own
  lock, WAL segment (``attach_wal``), ``kind_seq`` and newest committed
  resourceVersion, behind a router with the store's API. Versions come
  from one shared counter (``_SharedSeq``), so they stay unique and
  comparable; each partition's ``current_rv`` is the newest version it
  committed, the partition's component of the composite cursor.
- ``CompositeCursor``: the per-partition version vector a list is
  consistent at. A watch resumed from component p misses nothing
  partition p committed after the list, and a torn stream relists only
  its own partition.
- ``async_dispatch=True``: one watch dispatch thread a partition, so a
  stalled watcher of partition A never delays partition B. Synchronous
  dispatch (the default) keeps ``partitions=1`` event for event, version
  for version, the bare store.
- ``capacity_guard=True``: the bind-time arbiter for scheduler replicas
  that share nodes. The router sees every bind, whichever partition its
  pod lives in, keeps a ledger of each node's requested CPU and memory,
  and refuses a bind that would overfill a node with
  ``CapacityConflictError``; the losing replica unreserves, forgets and
  requeues the pod.
- A topology of 64 hash slots (``reshardable=True``) makes placement
  movable in process: ``migrate_slots``, ``spread_namespace``,
  ``retire_partition``, ``add_partition`` and ``restart_partition``
  move slices over the store's silent placement channel
  (``adopt_objects``, ``evict_objects``) under a bounded freeze.

Over REST the same routing drives the partition-aware client
(``client/restcluster.py``): one apiserver process a partition, one watch
stream a (kind, partition), bulk verbs split by partition.

The port's store delivers watch events in batches only
(``watch(batch_fn)``), and so does this router.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.apiserver.store import ClusterStore, Event

# High-volume kinds that spread across partitions. Namespaced kinds
# shard by (kind, namespace) — the issue key — so one namespace's
# objects stay colocated (list/watch scoped to a namespace touches ONE
# partition); cluster-scoped Node shards by name so heartbeat storms
# and node watch fan-out spread too. Everything else (services, RBAC,
# leases, CRDs, Events, ...) lives in partition 0: correctness for the
# long tail costs zero fan-out code.
SHARDED_NAMESPACED_KINDS = frozenset({"Pod"})
SHARDED_CLUSTER_KINDS = frozenset({"Node"})


def partition_for(kind: str, namespace: Optional[str], name: Optional[str],
                  partitions: int) -> int:
    """The routing function — crc32-based so every process (stores,
    servers, clients, creator children) computes the same shard."""
    if partitions <= 1:
        return 0
    if kind in SHARDED_NAMESPACED_KINDS:
        key = f"{kind}/{namespace or 'default'}"
    elif kind in SHARDED_CLUSTER_KINDS:
        key = f"{kind}/{name or ''}"
    else:
        return 0
    return zlib.crc32(key.encode()) % partitions


def partitions_for(kind: str, partitions: int,
                   namespace: Optional[str] = None) -> List[int]:
    """Which partitions can hold objects of ``kind`` (the list/watch
    fan-out set). A namespace-scoped query on a namespaced sharded kind
    touches exactly one partition."""
    if partitions <= 1:
        return [0]
    if kind in SHARDED_NAMESPACED_KINDS:
        if namespace is not None:
            return [partition_for(kind, namespace, None, partitions)]
        return list(range(partitions))
    if kind in SHARDED_CLUSTER_KINDS:
        return list(range(partitions))
    return [0]


# ---------------------------------------------------------------------------
# elastic topology: the partition layout as a RUNTIME quantity
#
# The static ``partition_for`` hash above fixes the layout at boot — the
# production failure mode at millions-of-users scale is exactly the one
# it cannot answer: one hot namespace saturating its shard while the
# others idle, or a partition process dying outright. The topology layer
# makes placement movable: the sharded keyspace is cut into NUM_SLOTS
# hash slots, each slot owned by a partition, and a migration moves a
# slot (under a bounded freeze-and-drain) without touching the rest of
# the keyspace. ``epoch`` increments on every layout change — clients
# re-route when they observe a newer epoch, and a server that no longer
# owns a slot answers 429 + the new epoch so stale routers converge.

NUM_SLOTS = 64


def slot_for(kind: str, namespace: Optional[str], name: Optional[str],
             slots: int = NUM_SLOTS,
             spread: frozenset = frozenset()) -> Optional[int]:
    """Hash-slot of an object, or None for the pinned long tail
    (everything that is not a sharded kind lives in partition 0 and
    never migrates). Namespaced sharded kinds slot by namespace —
    keeping a namespace colocated — UNLESS the namespace is in
    ``spread``: a namespace the rebalancer has SPLIT slots per object
    name, so one hot tenant's writes fan across every slot (and so
    across every partition) instead of pinning one shard."""
    if kind in SHARDED_NAMESPACED_KINDS:
        ns = namespace or "default"
        key = f"{kind}/{ns}/{name or ''}" if ns in spread \
            else f"{kind}/{ns}"
    elif kind in SHARDED_CLUSTER_KINDS:
        key = f"{kind}/{name or ''}"
    else:
        return None
    return zlib.crc32(key.encode()) % slots


class SliceFrozenError(RuntimeError):
    """A write aimed at a keyspace slice mid-migration outlived the
    freeze budget. Carries the computed ``retry_after`` the REST layer
    surfaces as 429 + Retry-After through the APF envelope."""

    def __init__(self, message: str, retry_after: float = 0.5):
        super().__init__(message)
        self.retry_after = float(retry_after)


class PartitionTopology:
    """The live routing table: ``owner[slot] -> partition`` plus the
    epoch, the spread-namespace set, and (over REST) the partition
    endpoint URLs. Immutable by convention — every layout change builds
    a successor via ``evolve`` with ``epoch + 1`` so observers compare
    a single integer to know whether they are stale."""

    __slots__ = ("partitions", "slots", "owner", "epoch", "spread",
                 "urls", "retired", "replicas")

    def __init__(self, partitions: int, owner: List[int], epoch: int = 1,
                 spread=frozenset(), urls: Optional[List[str]] = None,
                 retired=frozenset(),
                 replicas: Optional[Dict[int, List[str]]] = None):
        self.partitions = int(partitions)
        self.owner: Tuple[int, ...] = tuple(int(o) for o in owner)
        self.slots = len(self.owner)
        self.epoch = int(epoch)
        self.spread = frozenset(spread)
        self.urls = list(urls) if urls is not None else None
        self.retired = frozenset(retired)
        # read-tier advertisement: partition index -> read-replica URLs
        # (apiserver/readtier.py). Replicas serve lists and watches for
        # their partition's keyspace; writes always route to the owner.
        # Empty dict = no read tier (every read hits the owner).
        self.replicas: Dict[int, Tuple[str, ...]] = {
            int(p): tuple(u.rstrip("/") for u in us)
            for p, us in (replicas or {}).items() if us
        }

    @classmethod
    def default(cls, partitions: int, slots: int = NUM_SLOTS,
                urls: Optional[List[str]] = None) -> "PartitionTopology":
        return cls(partitions,
                   [i % max(1, partitions) for i in range(slots)],
                   epoch=1, urls=urls)

    def evolve(self, owner: Optional[List[int]] = None, spread=None,
               partitions: Optional[int] = None,
               urls: Optional[List[str]] = None,
               retired=None, replicas=None) -> "PartitionTopology":
        return PartitionTopology(
            partitions if partitions is not None else self.partitions,
            owner if owner is not None else self.owner,
            epoch=self.epoch + 1,
            spread=self.spread if spread is None else spread,
            urls=self.urls if urls is None else urls,
            retired=self.retired if retired is None else retired,
            replicas=self.replicas if replicas is None else replicas)

    def replicas_for(self, partition: int) -> Tuple[str, ...]:
        return self.replicas.get(int(partition), ())

    # -- routing -------------------------------------------------------
    def slot_of(self, kind: str, namespace: Optional[str],
                name: Optional[str]) -> Optional[int]:
        return slot_for(kind, namespace, name, self.slots, self.spread)

    def partition_of(self, kind: str, namespace: Optional[str],
                     name: Optional[str]) -> int:
        slot = self.slot_of(kind, namespace, name)
        return 0 if slot is None else self.owner[slot]

    def partitions_for(self, kind: str,
                       namespace: Optional[str] = None) -> List[int]:
        if kind in SHARDED_NAMESPACED_KINDS:
            if namespace is not None and namespace not in self.spread:
                return [self.owner[slot_for(kind, namespace, None,
                                            self.slots, self.spread)]]
            return sorted(set(self.owner))
        if kind in SHARDED_CLUSTER_KINDS:
            return sorted(set(self.owner))
        return [0]

    def slots_of_partition(self, partition: int) -> List[int]:
        return [s for s, o in enumerate(self.owner) if o == partition]

    # -- wire ----------------------------------------------------------
    def to_dict(self) -> dict:
        doc = {
            "epoch": self.epoch,
            "partitions": self.partitions,
            "slots": self.slots,
            "owner": list(self.owner),
            "spread": sorted(self.spread),
            "retired": sorted(self.retired),
        }
        if self.urls is not None:
            doc["urls"] = list(self.urls)
        if self.replicas:
            # JSON object keys are strings on the wire; from_dict
            # restores the integer partition indices
            doc["replicas"] = {
                str(p): list(us) for p, us in sorted(self.replicas.items())
            }
        return doc

    @classmethod
    def from_dict(cls, doc: dict) -> "PartitionTopology":
        return cls(int(doc["partitions"]), list(doc["owner"]),
                   epoch=int(doc.get("epoch", 1)),
                   spread=frozenset(doc.get("spread") or ()),
                   urls=doc.get("urls"),
                   retired=frozenset(doc.get("retired") or ()),
                   replicas={int(p): list(us) for p, us in
                             (doc.get("replicas") or {}).items()})

    def __repr__(self) -> str:
        return (f"PartitionTopology(epoch={self.epoch}, "
                f"partitions={self.partitions}, slots={self.slots}, "
                f"spread={sorted(self.spread)})")


class CapacityConflictError(ValueError):
    """A bind that would oversubscribe its target node — the
    multi-replica conflict verdict. Subclasses ValueError so every
    existing bind-failure path (positional ``bind_many`` errors, the
    REST 409 mapping, the scheduler's unreserve/forget/requeue unwind)
    handles it with no new plumbing; the scheduler additionally counts
    it into ``stale_binds_rejected_total{path=bind_conflict}``."""


class CompositeCursor:
    """Per-partition RV vector: the resourceVersion a partitioned list
    is consistent at. Encodes as ``"v0.v1.v2"``; a 1-partition cursor
    encodes as the bare integer so single-partition consumers see
    exactly today's RV strings."""

    __slots__ = ("rvs",)

    def __init__(self, rvs):
        self.rvs: Tuple[int, ...] = tuple(int(v) for v in rvs)

    def encode(self) -> str:
        return ".".join(str(v) for v in self.rvs)

    @classmethod
    def parse(cls, text: str) -> "CompositeCursor":
        return cls(int(p or 0) for p in str(text).split("."))

    def component(self, partition: int) -> int:
        return self.rvs[partition] if partition < len(self.rvs) else 0

    def covers(self, other: "CompositeCursor") -> bool:
        """True when every component is >= the other's — "this list is
        at least as fresh as that one" (resume-safety check)."""
        if len(self.rvs) != len(other.rvs):
            return False
        return all(a >= b for a, b in zip(self.rvs, other.rvs))

    def __eq__(self, other) -> bool:
        return isinstance(other, CompositeCursor) and self.rvs == other.rvs

    def __repr__(self) -> str:
        return f"CompositeCursor({self.encode()})"


class _SharedSeq:
    """The partitions' shared resourceVersion allocator: globally
    unique, monotone, and advanceable past WAL-restored revisions (a
    restored store must never re-issue an RV below what its segments
    already committed)."""

    __slots__ = ("_lock", "_v")

    def __init__(self, start: int = 0):
        self._lock = threading.Lock()
        self._v = int(start)

    def next(self) -> int:
        with self._lock:
            self._v += 1
            return self._v

    def advance_to(self, n: int) -> None:
        with self._lock:
            self._v = max(self._v, int(n))


class _PartitionHandle:
    """Composite watch handle: one underlying registration per
    partition (sync mode) or a subscriber-list entry (async mode)."""

    def __init__(self, stop_fn: Callable[[], None]):
        self._stop_fn = stop_fn

    def stop(self) -> None:
        self._stop_fn()


class _Dispatcher:
    """One partition's watch dispatch thread: events enqueue under the
    partition lock (cheap append + notify) and fan out to subscribers
    on THIS thread — a watcher that blocks here stalls only this
    partition's deliveries, never a sibling's."""

    def __init__(self, index: int, subscribers_fn):
        self.index = index
        self._subscribers_fn = subscribers_fn
        self._q: "queue.Queue[Optional[List[Event]]]" = queue.Queue()
        # pending batches counted under a condition (not an Event off
        # the queue's emptiness: submit() enqueues after any emptiness
        # check the worker could make, so drain() must wait on a
        # counter that is incremented BEFORE the put and decremented
        # only after delivery completed)
        self._cond = threading.Condition()
        self._pending = 0
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"partition-dispatch-{index}")
        self._thread.start()

    def submit(self, events: List[Event]) -> None:
        with self._cond:
            self._pending += 1
        self._q.put(events)

    def _run(self) -> None:
        while True:
            events = self._q.get()
            if events is None:
                return
            try:
                for batch_fn in self._subscribers_fn():
                    try:
                        batch_fn(events)
                    except Exception:  # noqa: BLE001 — one bad watcher
                        # must not kill the partition's dispatch thread
                        pass
            finally:
                with self._cond:
                    self._pending -= 1
                    if self._pending == 0:
                        self._cond.notify_all()

    def drain(self, timeout: float = 10.0) -> bool:
        with self._cond:
            return self._cond.wait_for(
                lambda: self._pending == 0, timeout)

    def stop(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=2.0)


class _BindLedger:
    """Node-capacity arbiter for concurrent scheduler replicas. The
    router sees EVERY bind (the pod's partition serializes same-pod
    races; this ledger serializes same-node capacity races across
    partitions): reserve-then-bind, release on store rejection, so two
    brains committing simultaneously cannot jointly exceed a node's
    allocatable. Tracks milli-CPU + memory, the two axes every bench
    workload requests."""

    def __init__(self):
        self._lock = threading.Lock()
        self._alloc: Dict[str, Tuple[int, int]] = {}
        self._used: Dict[str, List[int]] = {}
        self._pod_req: Dict[str, Tuple[str, int, int]] = {}

    @staticmethod
    def _pod_request(pod) -> Tuple[int, int]:
        milli = mem = 0
        for c in pod.spec.containers:
            req = c.resources.requests
            q = req.get("cpu")
            if q is not None:
                milli += int(q.milli_value())
            q = req.get("memory")
            if q is not None:
                mem += int(q.value())
        return milli, mem

    def note_node(self, node) -> None:
        alloc = node.status.allocatable or node.status.capacity or {}
        cpu = alloc.get("cpu")
        mem = alloc.get("memory")
        with self._lock:
            self._alloc[node.name] = (
                int(cpu.milli_value()) if cpu is not None else 1 << 62,
                int(mem.value()) if mem is not None else 1 << 62,
            )

    def drop_node(self, name: str) -> None:
        with self._lock:
            self._alloc.pop(name, None)

    # reserve() verdicts: the caller must know whether THIS call
    # charged the ledger — a failed bind may only release its OWN
    # reservation, never a concurrent winner's (releasing on a same-pod
    # CAS loss would silently leak the winner's capacity)
    CONFLICT = 0
    CHARGED = 1
    KEPT = 2

    def reserve(self, key: str, pod, node_name: str) -> int:
        """Charge the pod against the node. ``CONFLICT`` = would
        oversubscribe (the bind must be refused); ``CHARGED`` = this
        call took the reservation (release it if the bind fails);
        ``KEPT`` = an earlier reservation (possibly a racing sibling's)
        already covers the pod — not this call's to release. Unknown
        nodes are not judged — the store deliberately accepts binds
        into the void (the commit-time stale-node guards own that case)."""
        milli, mem = self._pod_request(pod)
        with self._lock:
            if key in self._pod_req:
                return self.KEPT
            alloc = self._alloc.get(node_name)
            if alloc is None:
                self._pod_req[key] = (node_name, milli, mem)
                return self.CHARGED
            used = self._used.setdefault(node_name, [0, 0])
            if used[0] + milli > alloc[0] or used[1] + mem > alloc[1]:
                return self.CONFLICT
            used[0] += milli
            used[1] += mem
            self._pod_req[key] = (node_name, milli, mem)
            return self.CHARGED

    def release(self, key: str, node_name: Optional[str] = None) -> None:
        """Drop the pod's reservation. With ``node_name`` given, only a
        reservation AGAINST THAT NODE is dropped — a losing bind must
        release exactly the charge it took, never one a racing sibling
        has since re-pointed to the node that actually won (confirm())."""
        with self._lock:
            got = self._pod_req.get(key)
            if got is None:
                return
            if node_name is not None and got[0] != node_name:
                return
            del self._pod_req[key]
            rec_node, milli, mem = got
            used = self._used.get(rec_node)
            if used is not None:
                used[0] -= milli
                used[1] -= mem

    def confirm(self, key: str, pod, node_name: str) -> None:
        """Align the ledger with a bind the store COMMITTED: whatever
        was reserved (possibly against a different node by a racing
        sibling whose target lost), the pod now occupies ``node_name``
        — charge it there unconditionally (committed truth outranks
        the budget; the guard's job was before the commit)."""
        milli, mem = self._pod_request(pod)
        with self._lock:
            got = self._pod_req.get(key)
            if got is not None:
                if got[0] == node_name:
                    return
                rec_node, r_milli, r_mem = got
                used = self._used.get(rec_node)
                if used is not None:
                    used[0] -= r_milli
                    used[1] -= r_mem
            used = self._used.setdefault(node_name, [0, 0])
            used[0] += milli
            used[1] += mem
            self._pod_req[key] = (node_name, milli, mem)


class PartitionedStore:
    """N independent store partitions behind today's ``ClusterStore``
    API. See the module docstring for the design; the router's job is
    purely mechanical — route single-object calls by ``partition_for``,
    fan list calls in, group bulk calls by partition, and keep the
    long tail (every non-sharded kind) on partition 0 so the untouched
    surface delegates via ``__getattr__``."""

    def __init__(self, partitions: int = 4, async_dispatch: bool = False,
                 capacity_guard: bool = False,
                 store_factory: Callable[..., ClusterStore] = ClusterStore,
                 topology: Optional[PartitionTopology] = None,
                 reshardable: bool = False,
                 evict_grace_s: float = 0.25):
        if partitions < 1:
            raise ValueError("partitions must be >= 1")
        self.partitions = int(partitions)
        self._store_factory = store_factory
        self._rv_seq = _SharedSeq()
        self.parts: List[ClusterStore] = [
            store_factory(rv_source=self._rv_seq.next)
            for _ in range(self.partitions)
        ]
        self._subs_lock = threading.Lock()
        self._subs: List[Callable[[List[Event]], None]] = []
        # sync-mode watcher registry: add_partition must re-register
        # every live watcher on the new partition (they subscribed to
        # the fleet, not to an index list frozen at boot)
        self._sync_watches: List[dict] = []
        self.async_dispatch = bool(async_dispatch)
        self._dispatchers: List[_Dispatcher] = []
        self._part_handles: List = []
        if self.async_dispatch:
            for i, part in enumerate(self.parts):
                self._attach_dispatcher(i, part)
        self.ledger = _BindLedger() if capacity_guard else None
        self._wals: List[Any] = []
        self._wal_dir: Optional[str] = None
        self._wal_kwargs: dict = {}
        self._watch_caches: Optional[List[Any]] = None
        # -- elastic layer (None topology = the static crc32 routing,
        # byte-identical; the differential guard depends on it) --------
        if topology is None and reshardable:
            topology = PartitionTopology.default(self.partitions)
        self.topology = topology
        self._reshard_lock = threading.Lock()
        self._freeze_cond = threading.Condition()
        self._frozen: Dict[int, float] = {}      # slot -> deadline (mono)
        self.slot_writes: Dict[int, int] = {}
        self.ns_writes: Dict[str, int] = {}
        self.migrations: List[dict] = []
        self.evict_grace_s = float(evict_grace_s)

    def _attach_dispatcher(self, index: int, part: ClusterStore) -> None:
        disp = _Dispatcher(index, self._subscribers)
        self._dispatchers.append(disp)
        self._part_handles.append(part.watch(
            lambda evs, d=disp: d.submit(list(evs))))

    # -- routing -------------------------------------------------------
    def _p(self, kind: str, namespace: Optional[str] = None,
           name: Optional[str] = None) -> ClusterStore:
        topo = self.topology
        if topo is not None:
            return self.parts[topo.partition_of(kind, namespace, name)]
        return self.parts[partition_for(kind, namespace, name,
                                        self.partitions)]

    def _fan(self, kind: str, namespace: Optional[str] = None
             ) -> List[ClusterStore]:
        topo = self.topology
        if topo is not None:
            return [self.parts[i]
                    for i in topo.partitions_for(kind, namespace)]
        return [self.parts[i]
                for i in partitions_for(kind, self.partitions, namespace)]

    # -- elastic routing: freeze-aware, flip-safe write/read paths -----
    def _wait_unfrozen(self, slot: Optional[int]) -> None:
        """Block while ``slot`` is inside a migration's freeze window
        (bounded: the window carries a deadline; a migration that dies
        auto-thaws). Raises ``SliceFrozenError`` with a computed
        retry-after only when the budget is exhausted — in the normal
        case a frozen write PAUSES briefly and lands on the new owner,
        invisible to the caller but for latency."""
        if slot is None or not self._frozen:
            return
        with self._freeze_cond:
            while True:
                deadline = self._frozen.get(slot)
                if deadline is None:
                    return
                now = time.monotonic()
                if now >= deadline:
                    # auto-thaw: a crashed migration must not freeze a
                    # slice forever (the rollback path unfreezes; this
                    # is the backstop)
                    self._frozen.pop(slot, None)
                    self._freeze_cond.notify_all()
                    return
                if not self._freeze_cond.wait(timeout=deadline - now):
                    remaining = self._frozen.get(slot)
                    if remaining is not None \
                            and time.monotonic() < remaining:
                        raise SliceFrozenError(
                            f"slot {slot} frozen by a live migration",
                            retry_after=max(
                                0.05, remaining - time.monotonic()))

    def _note_write(self, slot: Optional[int],
                    namespace: Optional[str]) -> None:
        # per-slot / per-namespace write ledger: the rebalancer's
        # hotspot signal (dict ops are GIL-atomic enough for a load
        # estimate; the ledger informs decisions, never correctness)
        if slot is not None:
            self.slot_writes[slot] = self.slot_writes.get(slot, 0) + 1
            if namespace is not None:
                self.ns_writes[namespace] = \
                    self.ns_writes.get(namespace, 0) + 1

    def _one_write(self, kind: str, namespace: Optional[str],
                   name: Optional[str], fn: Callable[[ClusterStore], Any]):
        """Route one mutation. Static mode is a plain dispatch; in
        topology mode the write re-validates its route UNDER the target
        partition's lock — a migration that flipped the slot while this
        writer waited on the lock re-routes it to the new owner instead
        of committing into an evicted slice (the torn-write race a
        check-then-act router would have)."""
        topo = self.topology
        if topo is None:
            return fn(self._p(kind, namespace, name))
        while True:
            slot = topo.slot_of(kind, namespace, name)
            self._wait_unfrozen(slot)
            part = self.parts[0 if slot is None else topo.owner[slot]]
            with part._lock:
                cur = self.topology
                cur_slot = cur.slot_of(kind, namespace, name)
                if (self.parts[0 if cur_slot is None
                               else cur.owner[cur_slot]] is part
                        and cur_slot not in self._frozen):
                    self._note_write(cur_slot, namespace
                                     if kind in SHARDED_NAMESPACED_KINDS
                                     else None)
                    return fn(part)
            topo = self.topology   # flipped under us: re-route

    def _one_read(self, kind: str, namespace: Optional[str],
                  name: Optional[str], fn: Callable[[ClusterStore], Any]):
        """Route one read, flip-safe (reads never block on a freeze —
        the source keeps serving until the flip, the destination
        after)."""
        topo = self.topology
        if topo is None:
            return fn(self._p(kind, namespace, name))
        while True:
            part = self.parts[topo.partition_of(kind, namespace, name)]
            with part._lock:
                cur = self.topology
                if self.parts[cur.partition_of(kind, namespace,
                                               name)] is part:
                    return fn(part)
            topo = self.topology

    def _bulk_write(self, kind: str, items: List[Any], key_of,
                    fn: Callable[[ClusterStore, List[Tuple[int, Any]]],
                                 None]) -> None:
        """Bulk mutation split by partition with the same flip-safety
        as ``_one_write``: each group re-validates every member's route
        under its partition lock; members a concurrent migration moved
        re-group and retry on the new owner. ``fn(part, [(index, item),
        ...])`` applies one group."""
        pending: List[Tuple[int, Any]] = list(enumerate(items))
        while pending:
            topo = self.topology
            groups: Dict[int, List[Tuple[int, Any]]] = {}
            for i, item in pending:
                ns, name = key_of(item)
                slot = topo.slot_of(kind, ns, name)
                self._wait_unfrozen(slot)
                groups.setdefault(
                    0 if slot is None else topo.owner[slot],
                    []).append((i, item))
            pending = []
            for p, group in groups.items():
                part = self.parts[p]
                with part._lock:
                    cur = self.topology
                    keep: List[Tuple[int, Any]] = []
                    for i, item in group:
                        ns, name = key_of(item)
                        slot = cur.slot_of(kind, ns, name)
                        owner = 0 if slot is None else cur.owner[slot]
                        if self.parts[owner] is part \
                                and slot not in self._frozen:
                            keep.append((i, item))
                            self._note_write(
                                slot, ns if kind in
                                SHARDED_NAMESPACED_KINDS else None)
                        else:
                            pending.append((i, item))
                    if keep:
                        fn(part, keep)

    def __getattr__(self, name: str):
        # the non-sharded long tail (services, RBAC, PV/PVC, CRDs,
        # leases, log/exec sources, ...) lives wholly in partition 0 —
        # its untouched ClusterStore surface IS the implementation
        if name.startswith("_") or name == "parts":
            raise AttributeError(name)
        return getattr(object.__getattribute__(self, "parts")[0], name)

    # event_ttl is a plain attribute on ClusterStore; writes must reach
    # partition 0 (where Events live), not shadow it on the router
    @property
    def event_ttl(self) -> float:
        return self.parts[0].event_ttl

    @event_ttl.setter
    def event_ttl(self, value: float) -> None:
        self.parts[0].event_ttl = value

    # -- watches -------------------------------------------------------
    def _subscribers(self) -> List[Callable[[List[Event]], None]]:
        with self._subs_lock:
            return list(self._subs)

    def watch(self, batch_fn: Callable[[List[Event]], None]):
        """Every later mutation batch of every partition, to ``batch_fn``:
        synchronously under that partition's lock, or (``async_dispatch``)
        on that partition's dispatch thread. Order holds within a
        partition, not across them."""
        if self.async_dispatch:
            entry = batch_fn
            with self._subs_lock:
                self._subs.append(entry)

            def stop() -> None:
                with self._subs_lock:
                    if entry in self._subs:
                        self._subs.remove(entry)

            return _PartitionHandle(stop)
        rec = {"batch_fn": batch_fn,
               "handles": [p.watch(batch_fn) for p in self.parts]}
        with self._subs_lock:
            self._sync_watches.append(rec)

        def stop_sync(rec=rec) -> None:
            with self._subs_lock:
                if rec in self._sync_watches:
                    self._sync_watches.remove(rec)
            for h in rec["handles"]:
                h.stop()

        return _PartitionHandle(stop_sync)

    def drain(self, timeout: float = 10.0) -> bool:
        """Block until every partition's dispatch queue is empty (async
        mode; tests and quiesce barriers)."""
        return all(d.drain(timeout) for d in self._dispatchers)

    def stop(self) -> None:
        for h in self._part_handles:
            h.stop()
        for d in self._dispatchers:
            d.stop()
        for wal in self._wals:
            with contextlib.suppress(Exception):
                wal.close()

    # -- resume (composite cursor) -------------------------------------
    def enable_resume(self, capacity: int = 100_000) -> None:
        """Attach one revisioned watch cache per partition — the
        replay half of list+watch resume (``watch_from_cursor``)."""
        if self._watch_caches is None:
            from kubernetes_tpu_torch.apiserver.watchcache import WatchCache

            self._watch_caches = [WatchCache(p, capacity=capacity)
                                  for p in self.parts]

    def cursor(self) -> CompositeCursor:
        """The store's current composite cursor (one component per
        partition: the newest revision that partition committed)."""
        return CompositeCursor(p.current_rv() for p in self.parts)

    def list_with_cursor(self, kind: str,
                         namespace: Optional[str] = None
                         ) -> Tuple[List[Any], CompositeCursor]:
        """List + the composite cursor the list is consistent at: a
        per-partition watch resumed from component p misses nothing
        partition p committed after its slice of this list."""
        objs: List[Any] = []
        rvs = [p.current_rv() for p in self.parts]
        for i in partitions_for(kind, self.partitions, namespace):
            got, rv = self.parts[i].list_objects_with_rv(kind, namespace)
            objs.extend(got)
            rvs[i] = rv
        return objs, CompositeCursor(rvs)

    def watch_from_cursor(self, cursor: CompositeCursor,
                          fn: Callable[[int, Event], None]):
        """Resume watching from a composite cursor: per partition,
        replay everything committed after the cursor component, then
        stream live (``enable_resume`` must have been called before the
        cursor was taken). A component that has been compacted out
        raises ``TooOldResourceVersion`` — the caller relists THAT
        partition only."""
        if self._watch_caches is None:
            raise RuntimeError("enable_resume() was never called")
        handles = []
        try:
            for i, cache in enumerate(self._watch_caches):
                handles.append(cache.watch_from(cursor.component(i), fn))
        except Exception:
            for h in handles:
                h.stop()
            raise
        return _PartitionHandle(lambda: [h.stop() for h in handles])

    # -- durability ----------------------------------------------------
    def attach_wal(self, wal_dir: str, restore: bool = False,
                   **kwargs) -> List[Any]:
        """One WAL segment per partition (``<dir>/p<k>/wal.jsonl``):
        partitions serialize their own mutations, so segments append
        with zero cross-partition contention and restore in any order.
        ``restore=True`` first replays each partition's snapshot+log
        (crash recovery) and advances the shared RV allocator past
        every restored revision — a recovered store must never re-issue
        a committed RV."""
        import os

        from kubernetes_tpu_torch.apiserver.wal import attach_wal, restore_store

        self._wal_dir = wal_dir
        self._wal_kwargs = dict(kwargs)
        for i, part in enumerate(self.parts):
            seg = os.path.join(wal_dir, f"p{i}")
            os.makedirs(seg, exist_ok=True)
            if restore:
                restore_store(seg, part)
            self._wals.append(attach_wal(part, seg, **kwargs))
        self._rv_seq.advance_to(max(p.current_rv() for p in self.parts))
        return list(self._wals)

    # -- observability -------------------------------------------------
    def partition_registries(self):
        """One tiny metrics registry per partition (scraped by the
        scale harness through the metrics federation as
        ``instance=partition-<k>``): latest committed RV, object
        count, and cumulative kind_seq mutations."""
        from kubernetes_tpu_torch.metrics.registry import Gauge, MetricsRegistry

        out = []
        for i, part in enumerate(self.parts):
            reg = MetricsRegistry()
            rv = Gauge("partition_resource_version",
                       "Newest revision this partition committed")
            objs = Gauge("partition_objects",
                         "Objects resident in this partition")
            muts = Gauge("partition_mutations_total",
                         "Cumulative per-kind mutation count")
            reg.register(rv)
            reg.register(objs)
            reg.register(muts)
            rv.set(float(part.current_rv()))
            with part._lock:
                objs.set(float(sum(
                    len(getattr(part, attr))
                    for attr, _ in part._KIND_TABLES.values())))
                muts.set(float(sum(part._kind_seq.values())))
            out.append(reg)
        return out

    # -- pods ----------------------------------------------------------
    def create_pod(self, pod):
        created = self._one_write(
            "Pod", pod.namespace, pod.metadata.name,
            lambda part: part.create_pod(pod))
        if self.ledger is not None and pod.spec.node_name:
            self.ledger.reserve(pod.full_name(), pod, pod.spec.node_name)
        return created

    def create_pods(self, pods):
        if self.topology is not None:
            self._bulk_write(
                "Pod", pods,
                lambda p: (p.namespace, p.metadata.name),
                lambda part, group: part.create_pods(
                    [p for _, p in group]))
        else:
            by_part: Dict[ClusterStore, list] = {}
            for pod in pods:
                by_part.setdefault(self._p("Pod", pod.namespace),
                                   []).append(pod)
            for part, group in by_part.items():
                part.create_pods(group)
        if self.ledger is not None:
            for pod in pods:
                if pod.spec.node_name:
                    self.ledger.reserve(pod.full_name(), pod,
                                        pod.spec.node_name)
        return pods

    def bind(self, namespace: str, name: str, uid: str,
             node_name: str) -> None:
        def run(part: ClusterStore) -> None:
            key = f"{namespace}/{name}"
            charged = False
            pod = None
            if self.ledger is not None:
                pod = part.get_pod(namespace, name)
                if pod is not None and not pod.spec.node_name:
                    verdict = self.ledger.reserve(key, pod, node_name)
                    if verdict == _BindLedger.CONFLICT:
                        raise CapacityConflictError(
                            f"pod {key}: capacity conflict on node "
                            f"{node_name!r} (concurrent replica won the "
                            f"remaining capacity)")
                    charged = verdict == _BindLedger.CHARGED
            try:
                part.bind(namespace, name, uid, node_name)
            except Exception:
                # release ONLY the reservation this call took (keyed to
                # its own node): on a same-pod CAS loss the surviving
                # charge — possibly already re-pointed by the winner's
                # confirm — belongs to the winner
                if charged:
                    self.ledger.release(key, node_name)
                raise
            if self.ledger is not None and pod is not None:
                # the store committed THIS node: align the ledger even
                # when a racing sibling reserved the pod against a
                # different target first (committed truth outranks the
                # reservation)
                self.ledger.confirm(key, pod, node_name)

        self._one_write("Pod", namespace, name, run)

    def _bind_group(self, part: ClusterStore, group, errors) -> None:
        """One partition's slice of a bulk bind: ledger precheck, bulk
        bind, per-item ledger settlement — shared by the static and
        topology-routed paths."""
        todo = []
        for i, b in group:
            namespace, name, uid, node_name = b
            charged = False
            pod = None
            if self.ledger is not None:
                key = f"{namespace}/{name}"
                pod = part.get_pod(namespace, name)
                if pod is not None and not pod.spec.node_name:
                    verdict = self.ledger.reserve(key, pod, node_name)
                    if verdict == _BindLedger.CONFLICT:
                        errors[i] = CapacityConflictError(
                            f"pod {key}: capacity conflict on node "
                            f"{node_name!r} (concurrent replica won "
                            f"the remaining capacity)")
                        continue
                    charged = verdict == _BindLedger.CHARGED
            todo.append((i, b, charged, pod))
        got = part.bind_many([b for _, b, _, _ in todo])
        for (i, b, charged, pod), err in zip(todo, got):
            errors[i] = err
            if self.ledger is None:
                continue
            key = f"{b[0]}/{b[1]}"
            if err is not None:
                # as in bind(): only this call's own reservation,
                # keyed to its own node
                if charged:
                    self.ledger.release(key, b[3])
            elif pod is not None:
                self.ledger.confirm(key, pod, b[3])

    def bind_many(self, bindings):
        errors: List[Optional[Exception]] = [None] * len(bindings)
        if self.topology is not None:
            self._bulk_write(
                "Pod", list(bindings), lambda b: (b[0], b[1]),
                lambda part, group: self._bind_group(part, group, errors))
            return errors
        by_part: Dict[ClusterStore, list] = {}
        for i, b in enumerate(bindings):
            by_part.setdefault(self._p("Pod", b[0]), []).append((i, b))
        for part, group in by_part.items():
            self._bind_group(part, group, errors)
        return errors

    def update_pod(self, pod):
        return self._one_write("Pod", pod.namespace, pod.metadata.name,
                               lambda part: part.update_pod(pod))

    def delete_pod(self, namespace: str, name: str) -> None:
        if self.ledger is not None:
            self.ledger.release(f"{namespace}/{name}")
        self._one_write("Pod", namespace, name,
                        lambda part: part.delete_pod(namespace, name))

    def delete_pods(self, keys) -> None:
        if self.ledger is not None:
            for namespace, name in keys:
                self.ledger.release(f"{namespace}/{name}")
        if self.topology is not None:
            self._bulk_write(
                "Pod", list(keys), lambda k: (k[0], k[1]),
                lambda part, group: part.delete_pods(
                    [k for _, k in group]))
            return
        by_part: Dict[ClusterStore, list] = {}
        for namespace, name in keys:
            by_part.setdefault(self._p("Pod", namespace),
                               []).append((namespace, name))
        for part, group in by_part.items():
            part.delete_pods(group)

    def get_pod(self, namespace: str, name: str):
        return self._one_read("Pod", namespace, name,
                              lambda part: part.get_pod(namespace, name))

    def list_pods(self, namespace: Optional[str] = None):
        out: List[Any] = []
        for part in self._fan("Pod", namespace):
            out.extend(part.list_pods(namespace))
        return out

    def patch_pod_condition(self, namespace: str, name: str,
                            condition) -> None:
        self._one_write("Pod", namespace, name,
                        lambda part: part.patch_pod_condition(
                            namespace, name, condition))

    def set_nominated_node_name(self, namespace: str, name: str,
                                node: str) -> None:
        self._one_write("Pod", namespace, name,
                        lambda part: part.set_nominated_node_name(
                            namespace, name, node))

    def clear_nominated_node_name(self, namespace: str, name: str) -> None:
        self._one_write("Pod", namespace, name,
                        lambda part: part.clear_nominated_node_name(
                            namespace, name))

    def set_pod_phase(self, namespace: str, name: str, phase: str,
                      pod_ip: str = "", host_ip: str = "") -> bool:
        return self._one_write(
            "Pod", namespace, name,
            lambda part: part.set_pod_phase(namespace, name, phase,
                                            pod_ip, host_ip))

    def batched_status_writes(self):
        return contextlib.nullcontext()

    def count_bound(self) -> int:
        return sum(p.count_bound() for p in self.parts)

    # -- nodes ---------------------------------------------------------
    def add_node(self, node) -> None:
        if self.ledger is not None:
            self.ledger.note_node(node)
        self._one_write("Node", None, node.name,
                        lambda part: part.add_node(node))

    def update_node(self, node) -> None:
        if self.ledger is not None:
            self.ledger.note_node(node)
        self._one_write("Node", None, node.name,
                        lambda part: part.update_node(node))

    def delete_node(self, name: str) -> None:
        if self.ledger is not None:
            self.ledger.drop_node(name)
        self._one_write("Node", None, name,
                        lambda part: part.delete_node(name))

    def get_node(self, name: str):
        return self._one_read("Node", None, name,
                              lambda part: part.get_node(name))

    def list_nodes(self):
        out: List[Any] = []
        for part in self._fan("Node"):
            out.extend(part.list_nodes())
        return out

    # -- generic typed-object surface ----------------------------------
    def kind_seq(self, kind: str) -> int:
        return sum(p.kind_seq(kind)
                   for p in self._fan(kind))

    def current_rv(self) -> int:
        return max(p.current_rv() for p in self.parts)

    def known_kinds(self):
        return self.parts[0].known_kinds()

    def kind_is_namespaced(self, kind: str) -> bool:
        return self.parts[0].kind_is_namespaced(kind)

    def create_object(self, kind: str, obj):
        if self.ledger is not None and kind == "Node":
            self.ledger.note_node(obj)
        return self._one_write(
            kind, obj.metadata.namespace, obj.metadata.name,
            lambda part: part.create_object(kind, obj))

    def create_objects_bulk(self, kind: str, objs) -> int:
        if self.ledger is not None and kind == "Node":
            for obj in objs:
                self.ledger.note_node(obj)
        if self.topology is not None:
            created = [0]

            def run(part, group):
                created[0] += part.create_objects_bulk(
                    kind, [o for _, o in group])

            self._bulk_write(
                kind, list(objs),
                lambda o: (o.metadata.namespace, o.metadata.name), run)
            return created[0]
        by_part: Dict[ClusterStore, list] = {}
        for obj in objs:
            by_part.setdefault(
                self._p(kind, obj.metadata.namespace, obj.metadata.name),
                []).append(obj)
        return sum(part.create_objects_bulk(kind, group)
                   for part, group in by_part.items())

    def update_object(self, kind: str, obj, expect_rv=None):
        return self._one_write(
            kind, obj.metadata.namespace, obj.metadata.name,
            lambda part: part.update_object(kind, obj,
                                            expect_rv=expect_rv))

    def delete_object(self, kind: str, namespace: str, name: str) -> bool:
        return self._one_write(
            kind, namespace, name,
            lambda part: part.delete_object(kind, namespace, name))

    def get_object(self, kind: str, namespace: str, name: str):
        return self._one_read(
            kind, namespace, name,
            lambda part: part.get_object(kind, namespace, name))

    def mutate_object(self, kind: str, namespace: str, name: str,
                      mutate, retries: int = 8):
        return self._one_write(
            kind, namespace, name,
            lambda part: part.mutate_object(kind, namespace, name,
                                            mutate, retries=retries))

    def list_objects(self, kind: str,
                     namespace: Optional[str] = None):
        return self.list_objects_with_rv(kind, namespace)[0]

    def list_objects_with_rv(self, kind: str,
                             namespace: Optional[str] = None):
        objs: List[Any] = []
        rv = 0
        for part in self._fan(kind, namespace):
            got, part_rv = part.list_objects_with_rv(kind, namespace)
            objs.extend(got)
            rv = max(rv, part_rv)
        return objs, rv

    # ------------------------------------------------------------------
    # live resharding: split / merge / move under a bounded freeze
    #
    # Protocol (one migration at a time, serialized by _reshard_lock):
    #   1. FREEZE the moving slots (writers pause on a condition, budget-
    #      bounded; readers keep flowing).
    #   2. Under ALL partition locks: copy every affected object to its
    #      new owner via the SILENT adopt channel (RVs preserved, no
    #      watch events — consumers already hold this state), then FLIP
    #      the topology (epoch + 1). Lists/gets serialize against the
    #      flip on the partition locks; the routed write/read wrappers
    #      re-validate after the flip.
    #   3. Unfreeze (writers resume against the new owner).
    #   4. After a short grace (so an in-flight fan-in list that chose
    #      its partition set pre-flip still finds the objects — dict-
    #      keyed consumers collapse the transient duplicate), EVICT the
    #      source copies silently.
    # Zero watch events are lost or duplicated: pre-flip events were
    # delivered from the source partition's stream, post-flip events
    # dispatch from the destination, and the seam itself is silent.

    def _require_topology(self) -> PartitionTopology:
        if self.topology is None:
            raise RuntimeError(
                "live resharding requires a topology "
                "(PartitionedStore(reshardable=True))")
        return self.topology

    def _live_partitions(self) -> List[int]:
        topo = self._require_topology()
        return [i for i in range(len(self.parts))
                if i not in topo.retired]

    def _migrate(self, new_topo: PartitionTopology,
                 freeze_slots: List[int], scan_parts: List[int],
                 freeze_budget_s: float, reason: str) -> dict:
        t0 = time.monotonic()
        with self._freeze_cond:
            deadline = time.monotonic() + freeze_budget_s
            for s in freeze_slots:
                self._frozen[s] = deadline
        moved = 0
        rv_barrier = 0
        evictions: List[Tuple[int, str, List[Tuple[str, str]]]] = []
        try:
            with contextlib.ExitStack() as stack:
                for part in self.parts:
                    stack.enter_context(part._lock)
                rv_barrier = max(p.current_rv() for p in self.parts)
                for src in scan_parts:
                    src_part = self.parts[src]
                    for kind in (tuple(SHARDED_NAMESPACED_KINDS)
                                 + tuple(SHARDED_CLUSTER_KINDS)):
                        attr, _ns = ClusterStore._KIND_TABLES[kind]
                        groups: Dict[int, List[Any]] = {}
                        for obj in getattr(src_part, attr).values():
                            dest = new_topo.partition_of(
                                kind, obj.metadata.namespace,
                                obj.metadata.name)
                            if dest != src:
                                groups.setdefault(dest, []).append(obj)
                        for dest, objs in groups.items():
                            self.parts[dest].adopt_objects(kind, objs)
                            moved += len(objs)
                            evictions.append((src, kind, [
                                (o.metadata.namespace, o.metadata.name)
                                for o in objs]))
                self.topology = new_topo
        finally:
            with self._freeze_cond:
                for s in freeze_slots:
                    self._frozen.pop(s, None)
                self._freeze_cond.notify_all()
        frozen_ms = (time.monotonic() - t0) * 1000.0
        if evictions:
            if self.evict_grace_s > 0:
                time.sleep(self.evict_grace_s)
            for src, kind, keys in evictions:
                self.parts[src].evict_objects(kind, keys)
        report = {
            "reason": reason,
            "epoch": new_topo.epoch,
            "moved_objects": moved,
            "frozen_slots": sorted(freeze_slots),
            "frozen_ms": round(frozen_ms, 3),
            "rv_barrier": rv_barrier,
        }
        self.migrations.append(report)
        return report

    def migrate_slots(self, assignments: Dict[int, int],
                      freeze_budget_s: float = 5.0) -> dict:
        """MOVE: reassign hash slots to new owner partitions
        (``{slot: dest_partition}``) under the freeze-and-drain
        protocol. Everything outside the moving slots stays hot."""
        with self._reshard_lock:
            topo = self._require_topology()
            owner = list(topo.owner)
            srcs = set()
            for slot, dest in assignments.items():
                if dest >= len(self.parts) or dest in topo.retired:
                    raise ValueError(f"bad destination partition {dest}")
                if owner[slot] != dest:
                    srcs.add(owner[slot])
                    owner[slot] = int(dest)
            if not srcs:
                return {"reason": "move", "epoch": topo.epoch,
                        "moved_objects": 0, "frozen_slots": [],
                        "frozen_ms": 0.0, "rv_barrier": 0}
            return self._migrate(
                topo.evolve(owner=owner),
                sorted(assignments), sorted(srcs),
                freeze_budget_s, "move")

    def spread_namespace(self, namespace: str,
                         freeze_budget_s: float = 5.0) -> dict:
        """SPLIT: a hot namespace stops slotting as one unit — its
        objects re-slot by (namespace, name), fanning one tenant's
        keyspace across every slot and so across every partition. The
        namespace's old slot freezes for the drain; everything else
        stays hot."""
        with self._reshard_lock:
            topo = self._require_topology()
            if namespace in topo.spread:
                return {"reason": "split", "epoch": topo.epoch,
                        "moved_objects": 0, "frozen_slots": [],
                        "frozen_ms": 0.0, "rv_barrier": 0}
            old_slot = topo.slot_of("Pod", namespace, None)
            src = topo.owner[old_slot]
            return self._migrate(
                topo.evolve(spread=topo.spread | {namespace}),
                [old_slot], [src], freeze_budget_s, "split")

    def retire_partition(self, index: int,
                         freeze_budget_s: float = 5.0) -> dict:
        """MERGE: drain a partition — every slot it owns migrates to
        the remaining live partitions (round-robin) and the partition
        is marked retired (it receives no further traffic; its process
        can be torn down)."""
        with self._reshard_lock:
            topo = self._require_topology()
            remaining = [i for i in self._live_partitions() if i != index]
            if not remaining:
                raise ValueError("cannot retire the last live partition")
            owner = list(topo.owner)
            moving = [s for s, o in enumerate(owner) if o == index]
            for k, slot in enumerate(moving):
                owner[slot] = remaining[k % len(remaining)]
            return self._migrate(
                topo.evolve(owner=owner,
                            retired=topo.retired | {index}),
                moving, [index], freeze_budget_s, "merge")

    def add_partition(self) -> int:
        """Grow the fleet by one (empty) partition — the control-plane
        autoscaler's buy. Slots migrate to it separately
        (``migrate_slots``), so the buy itself is instant."""
        with self._reshard_lock:
            topo = self._require_topology()
            idx = len(self.parts)
            part = self._store_factory(rv_source=self._rv_seq.next)
            if self._wal_dir is not None:
                import os

                from kubernetes_tpu_torch.apiserver.wal import attach_wal

                seg = os.path.join(self._wal_dir, f"p{idx}")
                os.makedirs(seg, exist_ok=True)
                self._wals.append(attach_wal(part, seg,
                                             **self._wal_kwargs))
            with self._subs_lock:
                for rec in self._sync_watches:
                    rec["handles"].append(part.watch(rec["batch_fn"]))
            if self._watch_caches is not None:
                from kubernetes_tpu_torch.apiserver.watchcache import WatchCache

                self._watch_caches.append(WatchCache(part))
            self.parts.append(part)
            self.partitions = len(self.parts)
            if self.async_dispatch:
                self._attach_dispatcher(idx, part)
            retired = topo.retired
            if idx in retired:
                retired = retired - {idx}
            self.topology = topo.evolve(partitions=self.partitions,
                                        retired=retired)
            return idx

    def restart_partition(self, index: int) -> dict:
        """FAILOVER: rebuild a (dead) partition from its WAL segment —
        RVs, adopted slices, and the shared allocator's high-water mark
        all survive; clients ride their cursors through the gap (the
        restarted partition's streams resume; at worst THAT partition
        relists, never its siblings)."""
        import os

        from kubernetes_tpu_torch.apiserver.wal import attach_wal, restore_store

        with self._reshard_lock:
            if self._wal_dir is None:
                raise RuntimeError(
                    "partition failover requires an attached WAL")
            seg = os.path.join(self._wal_dir, f"p{index}")
            if index < len(self._wals):
                with contextlib.suppress(Exception):
                    self._wals[index].close()
            fresh = self._store_factory(rv_source=self._rv_seq.next)
            restore_store(seg, fresh)
            self._rv_seq.advance_to(fresh.current_rv())
            restored = sum(
                len(getattr(fresh, attr))
                for attr, _ in ClusterStore._KIND_TABLES.values())
            if index < len(self._wals):
                self._wals[index] = attach_wal(fresh, seg,
                                               **self._wal_kwargs)
            with self._subs_lock:
                for rec in self._sync_watches:
                    with contextlib.suppress(Exception):
                        rec["handles"][index].stop()
                    rec["handles"][index] = fresh.watch(rec["batch_fn"])
            if self.async_dispatch and index < len(self._part_handles):
                disp = self._dispatchers[index]
                with contextlib.suppress(Exception):
                    self._part_handles[index].stop()
                self._part_handles[index] = fresh.watch(
                    lambda evs, d=disp: d.submit(list(evs)))
            if self._watch_caches is not None:
                from kubernetes_tpu_torch.apiserver.watchcache import WatchCache

                self._watch_caches[index].stop()
                self._watch_caches[index] = WatchCache(fresh)
            self.parts[index] = fresh
            if self.topology is not None:
                # epoch bump: observers must re-validate against the
                # restarted partition (its watch history is gone)
                self.topology = self.topology.evolve()
            report = {"reason": "failover", "partition": index,
                      "restored_objects": restored,
                      "epoch": self.topology.epoch
                      if self.topology else None}
            self.migrations.append(report)
            return report

    def reshard_stats(self) -> dict:
        """The rebalancer's decision feed: per-partition object and
        mutation totals plus the per-slot / per-namespace write ledgers
        (mirrored into the metrics federation by the caller)."""
        parts = []
        for i, p in enumerate(self.parts):
            with p._lock:
                objs = sum(len(getattr(p, attr))
                           for attr, _ in p._KIND_TABLES.values())
                muts = sum(p._kind_seq.values())
            parts.append({"partition": i, "objects": objs,
                          "mutations": muts,
                          "retired": self.topology is not None
                          and i in self.topology.retired})
        return {
            "epoch": self.topology.epoch
            if self.topology is not None else 0,
            "partitions": parts,
            "slot_writes": dict(self.slot_writes),
            "ns_writes": dict(self.ns_writes),
            "frozen": sorted(self._frozen),
            "migrations": len(self.migrations),
        }
