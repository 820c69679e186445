"""API Priority & Fairness for the REST fabric (KEP-1040; reference
``staging/src/k8s.io/apiserver/pkg/util/flowcontrol`` + its ``fairqueuing
/queueset``).

The raw readonly/mutating max-in-flight semaphores protect the server
but not the *tenants*: one hot client doing list storms or bulk-verb
abuse fills both lanes and starves the scheduler's bind traffic. This
module replaces the lanes as the admission decision for every
non-exempt request:

- **FlowSchemas** match requests (identity/groups/verb/resource/
  namespace, precedence-ordered with a catch-all) and route them to a
  priority level, deriving a **flow distinguisher** (the tenant key).
- **PriorityLevels** (system/control-plane, workload tenants,
  best-effort, plus a true ``exempt`` level) each hold an assured seat
  budget derived from the legacy lane budgets — shares of
  ``readonly + mutating`` total, so deploy-time tuning carries over.
- Each limited level runs a **QueueSet**: N bounded FIFO queues,
  **shuffle-sharded** flow assignment (hash of the distinguisher deals
  ``hand_size`` candidate queues; the request joins the shortest), and
  fair dispatch across queues by least-virtual-work — a noisy flow
  fills only its own hand of queues and never more than its fair share
  of seats.
- **Width estimation**: a request occupies ``seats >= 1`` while
  executing. Bulk ``{Kind}List`` verbs declare their item count
  (``X-Kubernetes-Request-Items``, the client-side analog of charging
  the token bucket per object) and consume proportional seats —
  batching must not launder concurrency. Expensive list GETs are
  widened by an EWMA of recently served list sizes, and watch
  initialization (the reconnect-herd replay burst) charges
  ``watch_init_seats`` released as soon as the stream attaches.
- On queue-full, queue-deadline, or **overload shed** (aggregate queued
  seat demand beyond ``shed_factor`` of total capacity: sheddable
  levels reject instead of queueing, protecting the control-plane
  level's bind/status traffic) the request is rejected 429 with an
  honest computed ``Retry-After`` (queued seats x average execution
  seconds / capacity — the level's actual drain time, never a
  hard-coded constant).

``FlowController.snapshot()`` feeds the ``/debug/apf`` introspection
endpoint and the chaos-suite invariants (no starved flow, exempt
always served, per-object rate equivalence for bulk verbs).
"""

from __future__ import annotations

import collections
import hashlib
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from kubernetes_tpu_torch.apiserver.faults import api_segments, namespace_of

__all__ = [
    "FlowControlConfig", "FlowController", "FlowSchema", "LaneStats",
    "PriorityLevelSpec", "Rejected", "Ticket", "WidthEstimator",
    "default_config", "is_collection_path", "namespace_of",
    "shuffle_shard_hand",
]


class Rejected(Exception):
    """Admission refused. Carries everything the 429 response needs."""

    def __init__(self, level: str, schema: str, reason: str,
                 retry_after: float):
        super().__init__(
            f"priority level {level!r} rejected request ({reason}); "
            f"retry after {retry_after:.3f}s")
        self.level = level
        self.schema = schema
        self.reason = reason
        self.retry_after = retry_after


def shuffle_shard_hand(flow_hash: int, deck_size: int,
                       hand_size: int) -> List[int]:
    """Deal ``hand_size`` DISTINCT queue indices out of ``deck_size``
    from the flow's hash (reference ``shufflesharding.Dealer``): two
    tenants share a whole hand only with probability ~(hand/deck)^hand,
    so a noisy flow drowning its own queues leaves every other flow a
    clean queue with high probability."""
    hand_size = max(1, min(hand_size, deck_size))
    remaining = list(range(deck_size))
    cards: List[int] = []
    h = flow_hash
    for i in range(hand_size):
        h, r = divmod(h, deck_size - i)
        cards.append(remaining.pop(r))
    return cards


def _flow_hash(level: str, flow_key: str) -> int:
    digest = hashlib.sha256(f"{level}\x00{flow_key}".encode()).digest()
    return int.from_bytes(digest[:8], "big")


# ---------------------------------------------------------------------------
# configuration


class FlowSchema:
    """Request classifier: ``match(user, groups, verb, resource, ns)``
    routes to ``priority_level`` with a flow distinguisher derived per
    ``distinguisher`` ("user" | "namespace" | "none"). Lower precedence
    wins, like the reference's matchingPrecedence."""

    def __init__(self, name: str, precedence: int, priority_level: str,
                 match: Optional[Callable[..., bool]] = None,
                 distinguisher: str = "user"):
        self.name = name
        self.precedence = int(precedence)
        self.priority_level = priority_level
        self._match = match
        self.distinguisher = distinguisher

    def matches(self, user: str, groups: Sequence[str], verb: str,
                resource: str, namespace: str) -> bool:
        if self._match is None:
            return True
        return bool(self._match(user, groups, verb, resource, namespace))

    def flow_key(self, user: str, namespace: str, flow_id: str) -> str:
        if self.distinguisher == "user":
            base = user
        elif self.distinguisher == "namespace":
            base = namespace
        else:
            base = ""
        # flow_id refines the flow within an identity (several tenants
        # behind one loopback identity in the bench harness). The server
        # forwards the X-Flow-Id header ONLY from control-plane/loopback
        # identities — an untrusted distinguisher would let one tenant
        # mint a flow per request and defeat shuffle-shard isolation.
        return f"{base}|{flow_id}" if flow_id else base


class PriorityLevelSpec:
    def __init__(self, name: str, shares: int = 10, queues: int = 8,
                 queue_length: int = 64, hand_size: int = 4,
                 sheddable: bool = False, exempt: bool = False):
        self.name = name
        self.shares = int(shares)
        self.queues = int(queues)
        self.queue_length = int(queue_length)
        self.hand_size = int(hand_size)
        self.sheddable = bool(sheddable)
        self.exempt = bool(exempt)


class FlowControlConfig:
    def __init__(self, levels: Sequence[PriorityLevelSpec],
                 schemas: Sequence[FlowSchema],
                 total_seats: int = 600,
                 queue_wait_s: float = 1.0,
                 shed_factor: float = 0.8):
        self.levels = list(levels)
        self.schemas = sorted(schemas, key=lambda s: s.precedence)
        self.total_seats = int(total_seats)
        self.queue_wait_s = float(queue_wait_s)
        self.shed_factor = float(shed_factor)
        by_level = {lv.name for lv in levels}
        for s in self.schemas:
            if s.priority_level not in by_level:
                raise ValueError(
                    f"schema {s.name!r} routes to unknown level "
                    f"{s.priority_level!r}")


def _is_control_plane(user, groups, verb, resource, ns) -> bool:
    return user.startswith(("system:kube-", "system:node:"))


def _is_master(user, groups, verb, resource, ns) -> bool:
    return "system:masters" in groups


def _is_authenticated(user, groups, verb, resource, ns) -> bool:
    return bool(user) and user != "system:anonymous" \
        and not user.startswith("token:")


def default_config(max_readonly_inflight: Optional[int],
                   max_mutating_inflight: Optional[int],
                   queue_wait_s: float = 1.0) -> FlowControlConfig:
    """The default tiering, with total seats derived from the legacy
    lane budgets (reference defaults 400 readonly + 200 mutating):

    - ``exempt``     — system:masters (the reference's exempt schema):
      cluster-admin traffic is never queued or charged;
    - ``system``     — control-plane identities (scheduler binds/status,
      kubelets, controller-manager): the traffic the headline metric
      rides on; protected, never shed;
    - ``workload``   — authenticated tenants, one flow per identity;
    - ``best-effort``— the catch-all (anonymous, unknown tokens).
    """
    total = (max_readonly_inflight or 400) + (max_mutating_inflight or 200)
    levels = [
        PriorityLevelSpec("exempt", exempt=True),
        PriorityLevelSpec("system", shares=40, queues=8, hand_size=4,
                          queue_length=128, sheddable=False),
        PriorityLevelSpec("workload", shares=40, queues=16, hand_size=4,
                          queue_length=64, sheddable=True),
        PriorityLevelSpec("best-effort", shares=20, queues=8, hand_size=4,
                          queue_length=32, sheddable=True),
    ]
    schemas = [
        FlowSchema("exempt", 0, "exempt", _is_master,
                   distinguisher="none"),
        FlowSchema("system-control-plane", 10, "system",
                   _is_control_plane),
        FlowSchema("workload-tenants", 20, "workload", _is_authenticated),
        FlowSchema("catch-all", 10_000, "best-effort"),
    ]
    return FlowControlConfig(levels, schemas, total_seats=total,
                             queue_wait_s=queue_wait_s)


# ---------------------------------------------------------------------------
# width estimation


class WidthEstimator:
    """Seats a request occupies while executing. Everything is 1 except
    the request shapes whose cost is proportional to object count:
    bulk verbs (declared item count), list GETs (EWMA of recently
    served list sizes per resource), watch initialization, and very
    large undeclared bodies (content-length fallback)."""

    def __init__(self, items_per_seat: int = 100,
                 list_objects_per_seat: int = 500,
                 bytes_per_seat: int = 256 * 1024,
                 bulk_item_bytes: int = 256,
                 max_seats: int = 10, watch_init_seats: int = 2):
        self.items_per_seat = int(items_per_seat)
        self.list_objects_per_seat = int(list_objects_per_seat)
        self.bytes_per_seat = int(bytes_per_seat)
        self.bulk_item_bytes = int(bulk_item_bytes)
        self.max_seats = int(max_seats)
        self.watch_init_seats = int(watch_init_seats)
        self._list_sizes: Dict[str, float] = {}

    def note_list_size(self, resource: str, n: int) -> None:
        """EWMA of served list sizes, fed by the server after every
        list response — the width of the NEXT list of this resource.
        Unlocked: float stores are GIL-atomic and this is an estimate."""
        prev = self._list_sizes.get(resource)
        self._list_sizes[resource] = float(n) if prev is None \
            else 0.7 * prev + 0.3 * n

    def estimate(self, verb: str, resource: str, is_collection_get: bool,
                 is_watch: bool, items_hint: int,
                 content_length: int,
                 is_collection_mutation: bool = False) -> int:
        if is_watch:
            return self.watch_init_seats
        if is_collection_mutation and content_length > 0:
            # bulk mutations price by the DECLARED item count, floored
            # by a conservative per-item byte estimate of the body — a
            # hostile tenant omitting X-Kubernetes-Request-Items (or
            # under-declaring "1" for a large body) must not launder a
            # wide bulk into one seat. bulk_item_bytes sits at the
            # binary codec's minimal per-object footprint (~200 B/pod)
            # so honest binary declarations dominate the floor; verbose
            # encodings (JSON ~700 B/pod) pay bytes-proportional seats,
            # which tracks their parse cost. A normal single-object
            # create (a few KiB) stays at 1 seat.
            floor_items = max(1, content_length // self.bulk_item_bytes)
            return self._clamp(math.ceil(
                max(items_hint, floor_items) / self.items_per_seat))
        if items_hint > 0:
            return self._clamp(math.ceil(items_hint / self.items_per_seat))
        if is_collection_get:
            est = self._list_sizes.get(resource, 0.0)
            return self._clamp(math.ceil(est / self.list_objects_per_seat)
                               if est else 1)
        if content_length > self.bytes_per_seat:
            return self._clamp(1 + content_length // self.bytes_per_seat)
        return 1

    def _clamp(self, seats: int) -> int:
        return max(1, min(self.max_seats, seats))


def is_collection_path(path: str) -> bool:
    """A route addressing a whole collection (plural resource, no
    object name) — the shape both expensive lists and bulk mutations
    arrive on. One parser: ``faults.api_segments``."""
    return len(api_segments(path)) == 1


# ---------------------------------------------------------------------------
# the queueing machinery


# execution-time EWMA weight and the honest Retry-After drain estimate,
# shared by the APF levels and the legacy lanes: both 429 paths must
# advertise the SAME math for the same server state, so a tuning of the
# clamp window or the EWMA weight can never diverge them
_EXEC_EWMA = 0.8


def _ewma_exec(avg_s: float, sample_s: float) -> float:
    return _EXEC_EWMA * avg_s + (1.0 - _EXEC_EWMA) * sample_s


def _drain_hint_s(seats: float, avg_exec_s: float, capacity: int) -> float:
    """Expected time for ``seats`` of queued work to drain at
    ``capacity`` concurrency, clamped to a sane advertising window."""
    drain = seats * avg_exec_s / max(1, capacity)
    return round(min(13.0, max(0.05, drain)), 3)


_WAITING, _GRANTED, _ABANDONED = 0, 1, 2


class _QueuedRequest:
    __slots__ = ("event", "width", "flow_key", "state", "enqueued_at",
                 "queue")

    def __init__(self, width: int, flow_key: str):
        self.event = threading.Event()
        self.width = width
        self.flow_key = flow_key
        self.state = _WAITING
        self.enqueued_at = time.monotonic()
        self.queue: Optional["_Queue"] = None   # set at enqueue: the
        # timeout-dequeue path removes from THIS queue directly instead
        # of scanning every queue under the level lock at saturation


class _Queue:
    __slots__ = ("items", "seats_queued", "vwork")

    def __init__(self):
        self.items: collections.deque = collections.deque()
        self.seats_queued = 0
        self.vwork = 0.0        # cumulative dispatched seats (virtual work)


class Ticket:
    """Held while a request executes; ``release()`` (idempotent) frees
    the seats and dispatches queued work. Watches release EARLY — right
    after the stream attaches — so a long-lived connection charges only
    its initialization burst."""

    __slots__ = ("_level", "width", "schema", "_released", "_t0",
                 "exec_sample")

    def __init__(self, level: Optional["_PriorityLevel"], width: int,
                 schema: str):
        self._level = level
        self.width = width
        self.schema = schema
        self._released = False
        self._t0 = time.monotonic()
        # False for watch-init tickets: their early release (right
        # after stream attach, ~1ms) must NOT feed the level's
        # execution-time EWMA — under a reconnect herd those samples
        # would collapse avg_exec_s toward 0 and every 429's computed
        # Retry-After to its floor, amplifying the very retry storm the
        # honest hint exists to damp
        self.exec_sample = True

    @property
    def level_name(self) -> str:
        return self._level.name if self._level is not None else "exempt"

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        if self._level is not None:
            self._level.release(
                self.width,
                (time.monotonic() - self._t0) if self.exec_sample
                else None)


class _PriorityLevel:
    """One limited level: seat pool + shuffle-sharded fair QueueSet."""

    def __init__(self, spec: PriorityLevelSpec, capacity: int,
                 controller: "FlowController"):
        self.name = spec.name
        self.spec = spec
        self.capacity = max(2, int(capacity))
        self._controller = controller
        self._lock = threading.Lock()
        self._queues = [_Queue() for _ in range(max(1, spec.queues))]
        self._vbase = 0.0        # virtual clock floor for waking queues
        self.executing_seats = 0
        self.queued_seats = 0    # read lock-free by the shed check
        self.queued_requests = 0
        self.peak_executing = 0
        self.dispatched_total = 0
        self.seats_dispatched_total = 0
        self.rejected: Dict[str, int] = {}
        self.avg_exec_s = 0.05
        self.flows: Dict[str, int] = {}

    # -- admission -----------------------------------------------------
    def admit(self, flow_key: str, width: int, queue_wait_s: float,
              shed_active: bool, schema: str) -> Ticket:
        width = min(width, self.capacity)
        m = self._controller.metrics
        with self._lock:
            if self.queued_requests == 0 \
                    and self.executing_seats + width <= self.capacity:
                self._grant_locked(flow_key, width)
                return Ticket(self, width, schema)
            if shed_active and self.spec.sheddable:
                return self._reject_locked(schema, "shed", width)
            q = self._pick_queue_locked(flow_key)
            if len(q.items) >= self.spec.queue_length:
                return self._reject_locked(schema, "queue-full", width)
            req = _QueuedRequest(width, flow_key)
            req.queue = q
            if not q.items:
                q.vwork = max(q.vwork, self._vbase)
            q.items.append(req)
            q.seats_queued += width
            self.queued_seats += width
            self.queued_requests += 1
            # seats may be free even while requests queue (a wide
            # request ahead didn't fit): give fair dispatch a chance
            # NOW — without this, nothing runs until the next release
            # and a narrow request can 429 on timeout beside idle seats
            self._dispatch_locked()
            if m is not None:
                m.current_inqueue_requests.set(self.queued_requests,
                                               self.name)
        granted = req.event.wait(queue_wait_s)
        waited = time.monotonic() - req.enqueued_at
        if m is not None:
            m.request_queue_wait_seconds.observe(waited, self.name)
        if granted:
            return Ticket(self, width, schema)
        with self._lock:
            if req.state == _GRANTED:
                # the grant raced the timeout: seats are already charged
                return Ticket(self, width, schema)
            req.state = _ABANDONED
            # still queued (states only change under this lock): remove
            # the entry here so dispatch never sees abandoned requests
            return self._reject_locked(schema, "timeout", width,
                                       dequeue=req)

    def _reject_locked(self, schema: str, reason: str, width: int,
                       dequeue: Optional[_QueuedRequest] = None):
        if dequeue is not None:
            self.queued_seats -= width
            self.queued_requests -= 1
            dequeue.queue.items.remove(dequeue)
            dequeue.queue.seats_queued -= width
            # a timed-out WIDE head may have been the only thing keeping
            # narrower requests behind it from fitting: dispatch now, or
            # they too idle toward their own timeouts beside free seats
            self._dispatch_locked()
        self.rejected[reason] = self.rejected.get(reason, 0) + 1
        retry_after = self._retry_after_locked(width)
        m = self._controller.metrics
        if m is not None:
            m.rejected_requests_total.inc(self.name, reason)
            m.current_inqueue_requests.set(self.queued_requests, self.name)
        raise Rejected(self.name, schema, reason, retry_after)

    def _grant_locked(self, flow_key: str, width: int) -> None:
        self.executing_seats += width
        self.peak_executing = max(self.peak_executing, self.executing_seats)
        self.dispatched_total += 1
        self.seats_dispatched_total += width
        if len(self.flows) < 512 or flow_key in self.flows:
            self.flows[flow_key] = self.flows.get(flow_key, 0) + 1
        m = self._controller.metrics
        if m is not None:
            m.dispatched_requests_total.inc(self.name)
            m.seats_dispatched_total.inc(self.name, amount=width)
            m.current_executing_seats.set(self.executing_seats, self.name)
            if self.executing_seats > m.peak_executing_seats.get(self.name):
                m.peak_executing_seats.set(self.executing_seats, self.name)

    def _pick_queue_locked(self, flow_key: str) -> _Queue:
        hand = shuffle_shard_hand(
            _flow_hash(self.name, flow_key), len(self._queues),
            self.spec.hand_size)
        return min((self._queues[i] for i in hand),
                   key=lambda q: (len(q.items), q.seats_queued))

    # -- completion + fair dispatch ------------------------------------
    def release(self, width: int, duration: Optional[float]) -> None:
        """``duration=None`` frees the seats without sampling the
        execution-time EWMA (watch-init tickets — see Ticket)."""
        with self._lock:
            self.executing_seats -= width
            if duration is not None:
                self.avg_exec_s = _ewma_exec(self.avg_exec_s, duration)
            self._dispatch_locked()
            m = self._controller.metrics
            if m is not None:
                m.current_executing_seats.set(self.executing_seats,
                                              self.name)
                m.current_inqueue_requests.set(self.queued_requests,
                                               self.name)

    def _dispatch_locked(self) -> None:
        """Fair dispatch: repeatedly serve the non-empty queue with the
        least cumulative dispatched seats (virtual work) whose head
        fits the free seats — seat-weighted round-robin across flows,
        the queueset's min-virtual-finish-time discipline."""
        while True:
            best: Optional[_Queue] = None
            for q in self._queues:
                if q.items and (best is None or q.vwork < best.vwork):
                    best = q
            if best is None:
                return
            head = best.items[0]
            if self.executing_seats + head.width > self.capacity:
                return
            best.items.popleft()
            best.seats_queued -= head.width
            self.queued_seats -= head.width
            self.queued_requests -= 1
            self._vbase = max(self._vbase, best.vwork)
            best.vwork += head.width
            head.state = _GRANTED
            self._grant_locked(head.flow_key, head.width)
            head.event.set()

    # -- introspection -------------------------------------------------
    def _retry_after_locked(self, width: int) -> float:
        return _drain_hint_s(self.queued_seats + width, self.avg_exec_s,
                             self.capacity)

    def retry_after(self, width: int = 1) -> float:
        with self._lock:
            return self._retry_after_locked(width)

    def snapshot(self) -> Dict:
        m = self._controller.metrics
        qwait_p99 = m.request_queue_wait_seconds.quantile(
            0.99, self.name) if m is not None else 0.0
        with self._lock:
            return {
                "capacity": self.capacity,
                "sheddable": self.spec.sheddable,
                "queue_wait_p99_s": round(qwait_p99, 4),
                "executing_seats": self.executing_seats,
                "queued_requests": self.queued_requests,
                "queued_seats": self.queued_seats,
                "peak_executing_seats": self.peak_executing,
                "dispatched_total": self.dispatched_total,
                "seats_dispatched_total": self.seats_dispatched_total,
                "rejected": dict(self.rejected),
                "avg_exec_s": round(self.avg_exec_s, 4),
                "queue_depths": [len(q.items) for q in self._queues],
                "flows": dict(sorted(self.flows.items(),
                                     key=lambda kv: -kv[1])[:64]),
            }


class FlowController:
    """Classification + admission, one instance per APIServer. The
    uncontended hot path is: classify (a few precedence-ordered match
    calls), estimate width, one lock acquire to charge seats — the
    fairness machinery costs nothing until queues form."""

    def __init__(self, config: FlowControlConfig, metrics=None):
        self.config = config
        if metrics is None:
            from kubernetes_tpu_torch.metrics.apf_metrics import apf_metrics

            metrics = apf_metrics()
        self.metrics = metrics
        self.width = WidthEstimator()
        limited = [lv for lv in config.levels if not lv.exempt]
        share_sum = sum(lv.shares for lv in limited) or 1
        self.levels: Dict[str, Optional[_PriorityLevel]] = {}
        self.total_capacity = 0
        for lv in config.levels:
            if lv.exempt:
                self.levels[lv.name] = None
                continue
            cap = max(2, round(config.total_seats * lv.shares / share_sum))
            level = _PriorityLevel(lv, cap, self)
            self.levels[lv.name] = level
            self.total_capacity += level.capacity
            if metrics is not None:
                metrics.request_concurrency_limit.set(level.capacity,
                                                      lv.name)
        self._schema_matched: Dict[str, int] = {}
        self._exempt_dispatched = 0
        # read-modify-write counters touched by every handler thread:
        # without this lock the /debug/apf match totals silently lose
        # increments under exactly the concurrency they diagnose
        self._stats_lock = threading.Lock()

    # -- classification ------------------------------------------------
    def classify(self, user: str, groups: Sequence[str], verb: str,
                 resource: str, namespace: str
                 ) -> Tuple[FlowSchema, Optional[_PriorityLevel]]:
        for schema in self.config.schemas:
            if schema.matches(user, groups, verb, resource, namespace):
                with self._stats_lock:
                    self._schema_matched[schema.name] = \
                        self._schema_matched.get(schema.name, 0) + 1
                return schema, self.levels[schema.priority_level]
        # unreachable with a catch-all schema; be safe anyway
        schema = self.config.schemas[-1]
        return schema, self.levels[schema.priority_level]

    def shed_active(self) -> bool:
        queued = sum(lv.queued_seats for lv in self.levels.values()
                     if lv is not None)
        return queued > self.config.shed_factor * self.total_capacity

    # -- admission -------------------------------------------------------
    def admit(self, user: str, groups: Sequence[str], verb: str,
              resource: str, namespace: str, flow_id: str = "",
              items_hint: int = 0, content_length: int = 0,
              is_watch: bool = False, path: str = "") -> Ticket:
        """Blocks while fairly queued; raises ``Rejected`` on queue-full
        / deadline / shed. Returns a ``Ticket`` to release on request
        completion (watches release right after attach)."""
        schema, level = self.classify(user, groups, verb, resource,
                                      namespace)
        if level is None:                      # exempt: never queued,
            with self._stats_lock:             # never charged seats
                self._exempt_dispatched += 1
            return Ticket(None, 0, schema.name)
        is_coll = bool(path) and is_collection_path(path)
        w = self.width.estimate(
            verb, resource,
            is_coll and verb in ("GET", "HEAD") and not is_watch,
            is_watch, items_hint, content_length,
            is_collection_mutation=is_coll
            and verb in ("POST", "PUT", "PATCH"))
        ticket = level.admit(schema.flow_key(user, namespace, flow_id), w,
                             self.config.queue_wait_s, self.shed_active(),
                             schema.name)
        if is_watch:
            # watch-init seats release at stream attach — milliseconds
            # that must not be mistaken for this level's execution time
            ticket.exec_sample = False
        return ticket

    # -- introspection ---------------------------------------------------
    def snapshot(self) -> Dict:
        return {
            "total_capacity": self.total_capacity,
            "queue_wait_s": self.config.queue_wait_s,
            "shed_factor": self.config.shed_factor,
            "shed_active": self.shed_active(),
            "exempt_dispatched_total": self._exempt_dispatched,
            "levels": {
                name: lv.snapshot()
                for name, lv in self.levels.items() if lv is not None
            },
            "schemas": [
                {"name": s.name, "precedence": s.precedence,
                 "priorityLevel": s.priority_level,
                 "matched_total": self._schema_matched.get(s.name, 0)}
                for s in self.config.schemas
            ],
        }


# ---------------------------------------------------------------------------
# legacy-lane Retry-After (the max-in-flight path keeps working when
# flow control is disabled, but its 429s must carry an honest hint too)


class LaneStats:
    """In-flight count + execution-time EWMA for one legacy lane, so a
    lane-full 429 can answer ``Retry-After = inflight x avg_exec /
    capacity`` (expected drain time) instead of a hard-coded 1s."""

    def __init__(self, capacity: Optional[int]):
        self.capacity = capacity or 1
        self.inflight = 0
        self.avg_exec_s = 0.05
        self._lock = threading.Lock()

    def start(self) -> None:
        with self._lock:
            self.inflight += 1

    def done(self, duration: float) -> None:
        with self._lock:
            self.inflight -= 1
            self.avg_exec_s = _ewma_exec(self.avg_exec_s, duration)

    def retry_after(self) -> float:
        with self._lock:
            return _drain_hint_s(max(1, self.inflight), self.avg_exec_s,
                                 self.capacity)
