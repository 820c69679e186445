"""ClusterStore-shaped client over the REST API: the scheduler's remote
half.

The port's scheduler stack (Scheduler, BatchScheduler, plugins, event
recorder) talks to one seam, a ClusterStore-shaped ``client``.
In-process runs hand it the store; this module hands it the network:
list and watch over chunked HTTP feed the same event handlers, binds go
through the Binding subresource in bulk, status writes through
``pods/{name}/status`` in bulk.

Wire discipline (the reference's scheduler_perf creates its clients at
QPS/Burst 5000):

- every call charges a client-side token bucket PER OBJECT — a bulk
  request of N pods costs N tokens, so batching never launders rate;
- pooled keep-alive connections with TCP_NODELAY per lane (read,
  write); after a transport failure the pool pre-warms a replacement
  under the retry backoff so retries never reconnect cold;
- hot-path writes ship as bulk verbs: creates as ``{Kind}List``, binds
  as ``BindingList`` (POST /bindings), status writes as
  ``PodStatusList`` (POST /statuses, see ``batched_status_writes``);
- the binary codec (``apiserver/codec.py``) carries every payload but
  the small status writes (JSON); a client with ``binary=False`` (an
  ordinary tenant: the server decodes binary bodies only from the
  control plane) sends and accepts JSON instead. Watch streams arrive as
  server-coalesced chunks (a batch of per-event pickles per read),
  decoded and delivered batch-at-a-time, to the same batch callback the
  in-process store's watch takes.

List, then watch: ``list_for_watch`` lists every watched kind with the
resourceVersion the list is consistent at, the scheduler replays those
lists into its cache and queue, and ``watch(batch_fn, resume=...)``
streams each kind from its list's version, so no event is missed
between the two and none the lists already hold is delivered again. A
bare ``watch`` takes those lists itself before it returns.

Reads the scheduler consults once per cycle (services, replica sets,
PDBs, ...) are served from short-TTL caches.

Partitioned control plane (``partition_urls``, one apiserver a store
partition, ``apiserver/partition.py``): single-object calls route by
``partition_for``, lists fan in from every partition a kind can live
in, bulk verbs (``BindingList``, ``PodStatusList``, ``{Kind}List``)
split by partition and go out at once on a shared executor, and the
watch opens one stream a (kind, partition), each listed, resumed and
relisted on its own partition's resourceVersion.
``check_partition_topology`` fails loudly on URLs in the wrong order.

The elastic topology (``enable_topology``): the client fetches the live
routing document and polls it. Single calls route by slot owner (read
again at each retry), a bulk slice refused by a moved-slice 429
(``X-Partition-Epoch``) splits again against the refreshed topology,
and the watch streams keep their reflector state here: on an epoch
change ``_replumb_streams`` stops the streams of retired or restarted
partitions, hands their known objects to the new owners' streams,
starts handoff streams whose first list delivers only the missed
difference, and catches up the partitions that gained keyspace. A
stream whose slice did not move is not touched (``stream_relists``
counts relists of torn streams; ``handoff_fetches`` the handoffs'
fetches). ``negotiated_codec`` records each partition's wire-version
pin, and a restart seam's re-pin counts in ``codec_renegotiations``.
Not here: read replicas.
"""

from __future__ import annotations

import http.client
import json
import random
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.serialization import from_wire, to_wire
from kubernetes_tpu_torch.apiserver import codec
from kubernetes_tpu_torch.apiserver.partition import (
    CompositeCursor,
    PartitionTopology,
    partition_for,
    partitions_for,
)
from kubernetes_tpu_torch.apiserver.rest import KIND_TO_PLURAL
from kubernetes_tpu_torch.apiserver.store import ADDED, DELETED, MODIFIED, Event
from kubernetes_tpu_torch.client.backoff import (
    Backoff,
    CircuitBreaker,
    RetryBudget,
)
from kubernetes_tpu_torch.observability.tracer import (
    TRACE_HEADER,
    format_trace_header,
    get_tracer,
    parse_trace_header,
)

# kinds the scheduler's event handlers consume
SCHEDULER_WATCH_KINDS = (
    "Pod", "Node", "Service", "PersistentVolume", "PersistentVolumeClaim",
    "StorageClass", "CSINode",
)

class TokenBucket:
    """Client-side rate limiter (reference client-go rate.Limiter)."""

    def __init__(self, qps: float, burst: Optional[float] = None):
        self.qps = float(qps)
        self.burst = float(burst if burst is not None else qps)
        self._tokens = self.burst
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def charge(self, n: float = 1.0) -> None:
        """Block until n tokens are available, then consume them. A
        charge above the burst is taken in burst-sized installments —
        the bucket can never hold more than ``burst``, so a single-shot
        wait would spin forever (client-go's WaitN just errors there;
        paying the time instead keeps bulk verbs rate-equivalent to N
        singles)."""
        remaining = float(n)
        while remaining > 0:
            take = min(remaining, self.burst)
            while True:
                with self._lock:
                    now = time.monotonic()
                    self._tokens = min(
                        self.burst,
                        self._tokens + (now - self._last) * self.qps)
                    self._last = now
                    if self._tokens >= take:
                        self._tokens -= take
                        break
                    wait = (take - self._tokens) / self.qps
                time.sleep(min(wait, 0.05))
            remaining -= take


class StaleRouteError(RuntimeError):
    """A bulk slice went to a server that no longer owns part of it (the
    topology's epoch moved under the split). The caller re-splits against
    the refreshed topology and sends again; raised only on the elastic
    path (``enable_topology``)."""


def _sever(conn) -> None:
    """Cross-thread stream teardown: shut the RAW socket down instead
    of ``conn.close()`` — closing an http.client connection while its
    owner thread is blocked in a read deadlocks on the buffered
    reader's lock; a socket shutdown just errors the read out."""
    if conn is None:
        return
    sock = getattr(conn, "sock", None)
    if sock is None:
        return
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def elect_trace_uid(uids) -> Optional[str]:
    """The trace-id election every client performs identically: the
    first locally-sampled uid (deterministic crc32 sampling), or None
    when tracing is off / nothing sampled. Shared with the federation
    tier so a cross-cluster hop elects the SAME trace id the
    per-cluster client will stamp on the wire."""
    tracer = get_tracer()
    if not tracer.enabled:
        return None
    for u in uids:
        if u and tracer.sampled(u):
            return u
    return None


def elect_trace_context(uids) -> Optional[str]:
    """Outgoing ``X-Ktpu-Trace`` value for a request touching these
    trace-id candidates (the bulk discipline: ONE context per batch,
    parented to the innermost open span). See
    ``RestClusterClient._trace_ctx_for`` for the contract text."""
    tracer = get_tracer()
    if not tracer.enabled:
        return None
    uids = list(uids)
    sampled = [u for u in uids if u and tracer.sampled(u)]
    if not sampled:
        return None
    parent = tracer.current_span_id()
    if len(uids) > 1:
        if not tracer.annotate_current(trace_uids=sampled):
            tracer.event("client.batch", trace=sampled[0],
                         uids=sampled, n=len(uids))
    return format_trace_header(sampled[0], parent, True)


def _key_of(obj) -> tuple:
    return (getattr(obj.metadata, "namespace", ""), obj.metadata.name)


def _rv_of(obj) -> int:
    try:
        return int(obj.metadata.resource_version or 0)
    except (TypeError, ValueError):
        return 0


def replace_diff(kind: str, known: Dict[Any, Any],
                 live: Dict[Any, Any]) -> List[Event]:
    """A relist as a diff: against ``known`` (what the consumer last
    saw), ``live`` (the fresh list) yields nothing for unchanged objects
    (same resourceVersion), MODIFIED carrying the last-known old for a
    changed one (a bind missed during the outage still reads as a bind
    transition), ADDED for new keys and a synthetic DELETED for vanished
    ones."""
    events: List[Event] = [
        Event(DELETED, kind, obj)
        for key, obj in known.items() if key not in live
    ]
    for key, obj in live.items():
        old = known.get(key)
        if old is None:
            events.append(Event(ADDED, kind, obj))
        elif (old.metadata.resource_version
              != obj.metadata.resource_version):
            events.append(Event(MODIFIED, kind, obj, old))
    return events


class _WatchHandle:
    def __init__(self, client: "RestClusterClient"):
        self._client = client

    def stop(self) -> None:
        self._client._stop_watches()


class _ConnPool:
    """Warm keep-alive connections for one (client, lane). Connections
    are checked out per request and returned on success; a transport
    failure discards the broken connection AND pre-warms a replacement
    during the retry backoff, so the retry itself never reconnects cold
    (reference: client-go's http.Transport connection pool per host)."""

    def __init__(self, host: str, port: int, timeout: float = 60.0,
                 max_idle: int = 8):
        self._host = host
        self._port = port
        self._timeout = timeout
        self.max_idle = max_idle
        self._idle: List[http.client.HTTPConnection] = []
        self._lock = threading.Lock()

    def _connect(self) -> http.client.HTTPConnection:
        conn = http.client.HTTPConnection(self._host, self._port,
                                          timeout=self._timeout)
        conn.connect()
        conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return conn

    def acquire(self) -> http.client.HTTPConnection:
        with self._lock:
            if self._idle:
                return self._idle.pop()
        return self._connect()

    def release(self, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            if len(self._idle) < self.max_idle:
                self._idle.append(conn)
                return
        try:
            conn.close()
        except OSError:
            pass

    @staticmethod
    def discard(conn: Optional[http.client.HTTPConnection]) -> None:
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def prewarm(self, n: int = 1) -> None:
        """Best-effort: open fresh connections into the idle set (called
        under retry backoff so the sleep pays the handshake)."""
        for _ in range(n):
            try:
                conn = self._connect()
            except OSError:
                return
            with self._lock:
                if len(self._idle) < self.max_idle:
                    self._idle.append(conn)
                    conn = None
            if conn is not None:
                _ConnPool.discard(conn)
                return

    def close_all(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, []
        for conn in idle:
            _ConnPool.discard(conn)


class RestClusterClient:
    """The store's contract over REST, against one apiserver or one a
    store partition."""

    # past this size, a bulk bind splits across two pipelined requests:
    # the client pickles chunk k+1 while the server applies chunk k
    _BIND_SPLIT = 1024

    # how long a cycle read (services, replica sets, PDBs...) is reused
    CACHE_TTL_S = 1.0
    # the most a 429's or 503's Retry-After makes a retry wait
    RETRY_AFTER_CAP_S = 2.0
    # consecutive transport failures that open the circuit breaker
    BREAKER_THRESHOLD = 5

    def __init__(self, base_url: str, token: str = "",
                 qps: Optional[float] = None, max_retries: int = 5,
                 binary: bool = True,
                 watch_kinds: Tuple[str, ...] = SCHEDULER_WATCH_KINDS,
                 retry_after_cap: float = RETRY_AFTER_CAP_S,
                 retry_budget: Optional[RetryBudget] = None,
                 retry_seed: Optional[int] = None,
                 partition_urls: Optional[List[str]] = None,
                 codec_version: int = codec.CODEC_VERSION):
        """A client of the apiserver at ``base_url`` authenticating with
        bearer ``token``; ``qps`` (None: unlimited) is the rate and the
        burst of its token bucket, charged an object at a time;
        ``max_retries`` bounds the retries of one request. ``binary``
        False speaks JSON on requests and responses; ``watch_kinds`` are
        the kinds ``list_for_watch`` and ``watch`` cover;
        ``retry_after_cap`` caps the wait a Retry-After asks for;
        ``retry_budget`` replaces the default budget (32 retries,
        refilled at 4 a second); ``retry_seed`` makes the backoff's
        jitter repeatable. ``partition_urls`` (the apiserver of each
        store partition, in partition order) makes the client
        partition-aware; ``base_url`` is then the first. ``codec_version``
        is the wire version stamped on every request (1 is the old
        version's, which the upgrade row's witness client speaks)."""
        urls = [u.rstrip("/") for u in (partition_urls or [base_url])]
        self.base_url = urls[0]
        self.partition_urls = urls
        self.partitions = len(urls)
        self._endpoints: List[Tuple[str, int]] = []
        for u in urls:
            host, _, port = u.split("://", 1)[1].partition(":")
            self._endpoints.append((host, int(port or 80)))
        self._host, self._port = self._endpoints[0]
        self.token = token
        self.binary = binary
        self.watch_kinds = tuple(watch_kinds)
        self.limiter = TokenBucket(qps) if qps else None
        # keep-alive pools per (partition, lane), the lanes mirroring the
        # server's readonly and mutating in-flight lanes: checked out per
        # request, pre-warmed on failure so retries ride an established
        # connection
        self._pools: Dict[Tuple[int, str], _ConnPool] = {
            (p, lane): _ConnPool(host, port)
            for p, (host, port) in enumerate(self._endpoints)
            for lane in ("ro", "rw")}
        self._pool_init_lock = threading.Lock()
        self._bind_pool = None
        self._fan_pool = None
        # active batched-status-write buffers per thread
        self._status_buffers = threading.local()
        self._ttl_cache: Dict[str, tuple] = {}
        self._stopping = threading.Event()
        self._watch_threads: List[threading.Thread] = []
        # each (kind, partition)'s live stream, so a stop can sever one
        # blocked in a read
        self._stream_conns: Dict[Tuple[str, int],
                                 http.client.HTTPConnection] = {}
        # resilience stack: jittered exponential backoff between retries,
        # a per-client retry budget so a sick server costs bounded extra
        # load, and a circuit breaker whose listener the scheduler wires
        # to degraded mode
        self.max_retries = int(max_retries)
        self.retry_after_cap = float(retry_after_cap)
        self._backoff = Backoff(
            base=0.05, factor=2.0, cap=2.0, jitter=0.4,
            rng=random.Random(retry_seed) if retry_seed is not None
            else None)
        self._retry_budget = retry_budget if retry_budget is not None \
            else RetryBudget(budget=32.0, refill_per_second=4.0)
        self.breaker = CircuitBreaker(
            failure_threshold=self.BREAKER_THRESHOLD)
        # resourceVersion monotonicity watchdog: list RVs per (kind,
        # partition) must never regress; violations are recorded, never
        # raised
        self._rv_lock = threading.Lock()
        self._last_rv: Dict[Tuple[str, int], int] = {}
        self.rv_regressions: List[Tuple[str, int, int]] = []
        # the elastic control plane: None is the static layout.
        # ``enable_topology`` fetches the live routing document, and from
        # then single calls route by slot owner, watch streams keep their
        # reflector state here, and an epoch change re-routes them
        # without relisting a slice that did not move
        self._topology: Optional[PartitionTopology] = None
        self.topology_epoch = 0
        self._topology_lock = threading.Lock()
        self._elastic_watching = False
        self._watch_batch_fn: Optional[Callable[[List[Event]], None]] = None
        # each (kind, partition) stream's reflector state: what it has
        # shown the consumer, (ns, name) -> last object
        self._known_lock = threading.Lock()
        self._stream_known: Dict[Tuple[str, int], Dict[tuple, Any]] = {}
        self._stream_stops: Dict[Tuple[str, int], threading.Event] = {}
        self._handoff_lock = threading.Lock()
        # relists of a torn stream, a (kind, partition); a handoff's
        # catch-up fetch counts in ``handoff_fetches`` instead
        self.stream_relists: Dict[Tuple[str, int], int] = {}
        self.handoff_fetches = 0
        self._topology_stop = threading.Event()
        self._topology_thread: Optional[threading.Thread] = None
        # routing can learn an epoch on any thread (a 429's epoch), the
        # stream surgery only on a replumbing caller: the epoch the
        # streams have caught up to, the partition indices whose endpoint
        # changed since, and the partitions that gained keyspace since
        self._replumb_epoch = 0
        self._pending_changed: set = set()
        self._pending_gained: set = set()
        # wire-version pin: the codec version this client speaks, stamped
        # on every request; the server echoes the pinned min(server,
        # client), recorded a partition
        self.codec_version = int(codec_version)
        self._codec_lock = threading.Lock()
        self.negotiated_codec: Dict[int, int] = {}
        self._codec_pending_reneg: set = set()
        self.codec_renegotiations = 0
        self.codec_failures = 0

    def set_degraded_listener(
            self, listener: Callable[[bool], None]) -> None:
        """``listener(degraded)`` fires when the circuit breaker opens
        (transport to the apiserver is gone) and again when it closes.
        The scheduler uses this to pause binding and resume cleanly."""
        self.breaker.set_listener(listener)

    # -- transport -----------------------------------------------------
    def _drop_conn(self) -> None:
        """Close every pooled keep-alive connection."""
        for pool in self._pools.values():
            pool.close_all()

    def close(self) -> None:
        """Stop the watch streams and close the pools."""
        self._stop_watches()
        self._drop_conn()
        with self._pool_init_lock:
            pools = (self._bind_pool, self._fan_pool)
            self._bind_pool = self._fan_pool = None
        for pool in pools:
            if pool is not None:
                pool.shutdown(wait=False)

    def _headers(self, body_binary: bool) -> Dict[str, str]:
        h: Dict[str, str] = {}
        if self.binary:
            h["Accept"] = codec.BINARY_CONTENT_TYPE
        h["Content-Type"] = codec.BINARY_CONTENT_TYPE if body_binary \
            else "application/json"
        if self.token:
            h["Authorization"] = f"Bearer {self.token}"
        h[codec.VERSION_HEADER] = str(self.codec_version)
        return h

    def _record_negotiated(self, partition: int, resp) -> None:
        """Record the echoed wire-version pin of one partition's server:
        a changed echo, or the first echo after a restart seam changed
        the partition's endpoint, is a re-negotiation; an echo above our
        own stamp a contract failure."""
        stamp = resp.headers.get(codec.VERSION_HEADER) if resp.headers \
            else None
        if stamp is None:
            return
        try:
            v = int(stamp)
        except ValueError:
            with self._codec_lock:
                self.codec_failures += 1
            return
        with self._codec_lock:
            if v > self.codec_version:
                self.codec_failures += 1
            prev = self.negotiated_codec.get(partition)
            if (prev is not None and prev != v) \
                    or partition in self._codec_pending_reneg:
                self.codec_renegotiations += 1
            self._codec_pending_reneg.discard(partition)
            self.negotiated_codec[partition] = v

    @staticmethod
    def _note_retry(verb: str, reason: str) -> None:
        # cold path only (a retry already costs a sleep)
        from kubernetes_tpu_torch.metrics.fabric_metrics import (
            fabric_metrics,
        )

        fabric_metrics().client_retries_total.inc(verb, reason)

    # -- fleet trace propagation ---------------------------------------
    @staticmethod
    def _trace_ctx_for(uids) -> Optional[str]:
        """Outgoing ``X-Ktpu-Trace`` value for a request touching these
        trace-id candidates (pod uids where they exist, ns/name keys
        otherwise), or None when tracing is off or nothing is sampled:
        ONE context per object batch, the first locally-sampled uid,
        with the explicit sampled bit."""
        return elect_trace_context(uids)

    @staticmethod
    def _observe_delivery(kind: str, events: List[Event]) -> None:
        """Freshness SLI: commit to decode latency for a decoded watch
        batch, one ``observe_many`` per batch; stamp-less events are
        skipped."""
        try:
            from kubernetes_tpu_torch.metrics.freshness_metrics import (
                freshness_metrics,
            )

            fm = freshness_metrics()
            if not fm.enabled:
                return
            now = time.time()
            lags = [max(0.0, now - e.ts) for e in events if e.ts]
            if lags:
                fm.watch_delivery_seconds.observe_many(lags, kind)
        except Exception:  # noqa: BLE001 — SLIs must never break watches
            pass

    @staticmethod
    def _trace_watch_delivery(events: List[Event]) -> None:
        """Stamp a ``watch.deliver`` span for each event carrying a
        SAMPLED commit-time origin context: commit to client decode, the
        cross-process hop of the pod's causal trace. The span's start
        back-dates by the freshness lag (the processes share a host, so
        wall clock is the common reference)."""
        tracer = get_tracer()
        if not tracer.enabled:
            return
        now_m = now_w = None
        for e in events:
            origin = getattr(e, "origin", None)
            if not origin:
                continue
            ctx = parse_trace_header(origin)
            if ctx is None \
                    or not tracer.sampled(ctx.trace,
                                          inbound=ctx.sampled):
                continue
            if now_m is None:
                now_m, now_w = time.monotonic(), time.time()
            start = now_m - max(0.0, now_w - e.ts) if e.ts else now_m
            tracer.record("watch.deliver", start, now_m,
                          trace=ctx.trace, ctx_parent=ctx.parent,
                          kind=e.kind)

    def _request(self, method: str, path: str, payload: Any = None,
                 charge: float = 1.0, body_binary: Optional[bool] = None,
                 retries: Optional[int] = None,
                 trace_ctx: Optional[str] = None,
                 partition: int = 0,
                 route: Optional[Callable[[], int]] = None,
                 raise_on_stale: bool = False) -> Tuple[int, Any]:
        """One request to ``partition``'s apiserver (``route()``'s, read
        again at every attempt, when given) with the client's
        discipline: the token bucket charged ``charge`` objects, retries
        on transport errors and on 429/503 (honoring Retry-After, capped
        at ``retry_after_cap``) within the retry budget, the circuit
        breaker fed. A 429 naming a newer topology epoch refreshes the
        routing, and with ``raise_on_stale`` (a bulk slice) raises
        ``StaleRouteError`` for the caller to re-split. The body goes
        binary unless ``body_binary`` (default: the client's
        ``binary``) is False. Returns (status, decoded body)."""
        if body_binary is None:
            body_binary = self.binary
        if self.limiter is not None:
            self.limiter.charge(charge)
        data = None
        if payload is not None:
            data = codec.encode(payload) if body_binary \
                else json.dumps(payload).encode()
        if route is not None:
            partition = route()
        lane = "ro" if method in ("GET", "HEAD") else "rw"
        pool = self._pools[(partition, lane)]
        headers = self._headers(body_binary)
        if trace_ctx:
            # retries re-send the SAME context: a retried hop stays one
            # trace
            headers[TRACE_HEADER] = trace_ctx
        if charge > 1:
            # declare the per-object count so the server's APF width
            # estimation charges proportional seats
            headers["X-Kubernetes-Request-Items"] = str(int(charge))
        conn: Optional[http.client.HTTPConnection] = None
        max_r = self.max_retries if retries is None else int(retries)
        attempt = 0
        while True:
            try:
                if conn is None:
                    conn = pool.acquire()
                conn.request(method, path, body=data, headers=headers)
                resp = conn.getresponse()
                raw = resp.read()
            except (http.client.HTTPException, OSError):
                # dropped/reset keep-alive or truncated response: retry
                # on a FRESH pooled connection with jittered backoff —
                # requests here are idempotent or conflict-detected
                # server-side. Budget exhaustion surfaces the ORIGINAL
                # transport error.
                _ConnPool.discard(conn)
                conn = None
                self.breaker.record_failure()
                if attempt >= max_r \
                        or not self._retry_budget.try_spend():
                    raise
                self._note_retry(method, "transport")
                time.sleep(self._backoff.delay(attempt))
                attempt += 1
                # resolve the route and the pool again: a restart seam
                # may have re-pointed this partition at its successor
                # during the backoff, and a retry pinned to the old pool
                # would dial the dead port until the budget ran out
                if route is not None:
                    partition = route()
                pool = self._pools[(partition, lane)]
                pool.prewarm(1)
                continue
            if resp.status == 429 \
                    and resp.headers.get("X-Partition-Epoch"):
                # a moved slice: this server no longer owns part of the
                # request's keyspace and named the live epoch (a frozen
                # slice carries no epoch: its cure is the Retry-After
                # wait below). Refresh the routing, then retry at the
                # owner, or have the caller re-split its batch
                try:
                    new_epoch = int(resp.headers.get("X-Partition-Epoch"))
                except ValueError:
                    new_epoch = 0
                if resp.will_close:
                    _ConnPool.discard(conn)
                else:
                    pool.release(conn)
                conn = None
                self.breaker.record_success()
                if new_epoch > self.topology_epoch:
                    try:
                        # the refusing server holds the newer document
                        self.refresh_topology(partition=partition,
                                              replumb=False)
                    except Exception:  # noqa: BLE001 — retried below
                        pass
                if raise_on_stale and route is None:
                    # even an equal epoch re-groups a batch split before
                    # the flip correctly
                    raise StaleRouteError(
                        f"topology epoch {new_epoch}: re-split needed")
                if attempt >= max_r \
                        or not self._retry_budget.try_spend():
                    ctype = resp.headers.get("Content-Type") or ""
                    if ctype.startswith(codec.BINARY_CONTENT_TYPE):
                        return resp.status, codec.decode(raw)
                    return resp.status, (json.loads(raw) if raw else {})
                try:
                    advertised = float(
                        resp.headers.get("Retry-After") or 0.0)
                except ValueError:
                    advertised = 0.0
                self._note_retry(method, "reshard")
                time.sleep(min(max(advertised,
                                   self._backoff.delay(attempt)),
                               self.retry_after_cap))
                attempt += 1
                if route is not None:
                    partition = route()
                pool = self._pools[(partition, lane)]
                continue
            if resp.status in (429, 503) and attempt < max_r \
                    and self._retry_budget.try_spend():
                # overload pushback: honor Retry-After, CAPPED. A 429 is
                # the flow-control layers talking: overload is NOT
                # outage, so the breaker hears health. A 503 (fault
                # injection or a failing server) stays breaker-neutral.
                if resp.status == 429:
                    self.breaker.record_success()
                if resp.will_close:
                    _ConnPool.discard(conn)
                    conn = None
                try:
                    advertised = float(
                        resp.headers.get("Retry-After") or 0.0)
                except ValueError:
                    advertised = 0.0
                pf_level = resp.headers.get(
                    "X-Kubernetes-PF-PriorityLevel") or ""
                self._note_retry(
                    method,
                    f"apf_{pf_level}" if pf_level
                    else f"http_{resp.status}")
                time.sleep(min(max(advertised,
                                   self._backoff.delay(attempt)),
                               self.retry_after_cap))
                attempt += 1
                continue
            if resp.status != 503:
                self.breaker.record_success()
            if resp.will_close:
                _ConnPool.discard(conn)
            else:
                pool.release(conn)
            self._record_negotiated(partition, resp)
            ctype = resp.headers.get("Content-Type") or ""
            if ctype.startswith(codec.BINARY_CONTENT_TYPE):
                return resp.status, codec.decode(raw)
            return resp.status, (json.loads(raw) if raw else {})

    @staticmethod
    def _raise_for(code: int, payload: Any) -> None:
        if code < 400:
            return
        msg = payload.get("message", "") if isinstance(payload, dict) \
            else str(payload)
        if code == 404:
            raise KeyError(msg)
        if code in (403, 422):
            raise PermissionError(msg)
        if code == 409:
            raise ValueError(msg)
        raise RuntimeError(f"HTTP {code}: {msg}")

    # -- paths ---------------------------------------------------------
    @staticmethod
    def _path(kind: str, namespace: Optional[str] = None,
              name: Optional[str] = None, sub: Optional[str] = None) -> str:
        plural = KIND_TO_PLURAL.get(kind, kind.lower() + "s")
        p = f"/api/v1/namespaces/{namespace}/{plural}" if namespace \
            else f"/api/v1/{plural}"
        if name:
            p += f"/{name}"
        if sub:
            p += f"/{sub}"
        return p

    def _list(self, kind: str, namespace: Optional[str] = None) -> List[Any]:
        return self._list_with_rv(kind, namespace)[0]

    def _pk(self, kind: str, namespace: Optional[str],
            name: Optional[str]) -> int:
        """The partition an object lives in: its slot's owner under a
        live topology, else the static routing function's."""
        topo = self._topology
        if topo is not None:
            return topo.partition_of(kind, namespace, name)
        return partition_for(kind, namespace, name, self.partitions)

    def _pset(self, kind: str, namespace: Optional[str] = None
              ) -> List[int]:
        """The partitions a kind (of a namespace) can live in."""
        topo = self._topology
        if topo is not None:
            return topo.partitions_for(kind, namespace)
        return partitions_for(kind, self.partitions, namespace)

    def _list_with_rv(self, kind: str, namespace: Optional[str] = None,
                      partition: Optional[int] = None
                      ) -> Tuple[List[Any], int]:
        """A list and the resourceVersion it is consistent at, from
        ``partition``, or fanned in from every partition the kind can
        live in (the version is then the largest). The monotonicity
        watchdog records a partition's version that went backwards."""
        if partition is None:
            parts = self._pset(kind, namespace)
            if len(parts) > 1:
                got = self._fan_out().map(
                    lambda p: self._list_with_rv(kind, namespace, p), parts)
                objs: List[Any] = []
                rv = 0
                for items, part_rv in got:
                    objs.extend(items)
                    rv = max(rv, part_rv)
                return objs, rv
            partition = parts[0]
        code, payload = self._request("GET", self._path(kind, namespace),
                                      partition=partition)
        self._raise_for(code, payload)
        rv = int(payload["resourceVersion"])
        items = payload["items"]
        if items and isinstance(items[0], dict):   # the JSON wire
            items = [from_wire(i, kind) for i in items]
        with self._rv_lock:
            last = self._last_rv.get((kind, partition), 0)
            if rv < last:
                self.rv_regressions.append((kind, last, rv))
            else:
                self._last_rv[(kind, partition)] = rv
        return items, rv

    def _get(self, kind: str, namespace: Optional[str],
             name: str) -> Optional[Any]:
        code, payload = self._request(
            "GET", self._path(kind, namespace, name),
            route=lambda: self._pk(kind, namespace, name))
        if code == 404:
            return None
        self._raise_for(code, payload)
        if isinstance(payload, dict):   # the JSON wire
            return from_wire(payload, kind)
        return payload

    def _cached(self, key: str, fetch: Callable[[], Any]) -> Any:
        hit = self._ttl_cache.get(key)
        now = time.monotonic()
        if hit is not None and now - hit[0] < self.CACHE_TTL_S:
            return hit[1]
        value = fetch()
        self._ttl_cache[key] = (now, value)
        return value

    # -- hot reads (no cache: the scheduler replays them into its own
    # cache and queue at start, and consults get_pod only on failures)
    def list_pods(self, namespace: Optional[str] = None) -> List[Any]:
        return self._list("Pod", namespace)

    def list_nodes(self) -> List[Any]:
        return self._list("Node")

    def get_pod(self, namespace: str, name: str) -> Optional[Any]:
        return self._get("Pod", namespace, name)

    # -- nodes (the autoscaler's provisioner and cordons)
    def get_node(self, name: str) -> Optional[Any]:
        return self._get("Node", None, name)

    def add_node(self, node) -> None:
        """An upsert, as ``store.add_node``: a node registering again
        after a restart must not conflict."""
        try:
            self.create_object("Node", node)
        except ValueError:
            self.update_object("Node", node)

    def update_node(self, node) -> None:
        self.update_object("Node", node)

    def delete_node(self, name: str) -> None:
        code, payload = self._request("DELETE",
                                      self._path("Node", None, name),
                                      route=lambda: self._pk("Node", None,
                                                             name))
        if code >= 400 and code != 404:
            self._raise_for(code, payload)

    def try_acquire_or_renew(self, name: str, holder: str, now: float,
                             duration: float) -> bool:
        """The store's lease verb over REST (POST
        .../leases/{name}/acquire); ``now`` is the server's clock, one
        clock arbitrating expiry across processes."""
        code, payload = self._request(
            "POST", f"/api/v1/leases/{name}/acquire",
            {"holder": holder, "duration": duration},
            body_binary=False)
        self._raise_for(code, payload)
        return bool(payload.get("acquired"))

    def lease_holder(self, name: str) -> Optional[str]:
        obj = self._get("Lease", "kube-system", name)
        return getattr(obj, "holder_identity", None) if obj is not None \
            else None

    # -- cycle reads (TTL-cached) --------------------------------------
    def list_services(self, namespace: str) -> List[Any]:
        return self._cached(f"svc/{namespace}",
                            lambda: self._list("Service", namespace))

    def list_replication_controllers(self, namespace: str) -> List[Any]:
        return self._cached(
            f"rc/{namespace}",
            lambda: self._list("ReplicationController", namespace))

    def list_replica_sets(self, namespace: str) -> List[Any]:
        return self._cached(f"rs/{namespace}",
                            lambda: self._list("ReplicaSet", namespace))

    def list_stateful_sets(self, namespace: str) -> List[Any]:
        return self._cached(f"sts/{namespace}",
                            lambda: self._list("StatefulSet", namespace))

    def list_pdbs(self) -> List[Any]:
        return self._cached("pdbs",
                            lambda: self._list("PodDisruptionBudget"))

    def list_pvs(self) -> List[Any]:
        return self._cached("pvs", lambda: self._list("PersistentVolume"))

    def list_csi_nodes(self) -> List[Any]:
        return self._cached("csinodes", lambda: self._list("CSINode"))

    def get_pvc(self, namespace: str, name: str) -> Optional[Any]:
        return self._get("PersistentVolumeClaim", namespace, name)

    def get_pv(self, name: str) -> Optional[Any]:
        return self._get("PersistentVolume", None, name)

    def get_storage_class(self, name: str) -> Optional[Any]:
        return self._cached(f"sc/{name}",
                            lambda: self._get("StorageClass", None, name))

    def get_csi_node(self, name: str) -> Optional[Any]:
        return self._get("CSINode", None, name)

    # -- binds ---------------------------------------------------------
    def bind(self, namespace: str, name: str, uid: str,
             node_name: str) -> None:
        code, payload = self._request(
            "POST", self._path("Pod", namespace, name, "binding"),
            {"kind": "Binding", "uid": uid, "target": {"name": node_name}},
            body_binary=False,
            route=lambda: self._pk("Pod", namespace, name))
        self._raise_for(code, payload)

    # -- partition fan-out ---------------------------------------------
    def _fan_out(self):
        """The shared executor bulk verbs and list fan-ins go out on, one
        request a partition at once (each partition's server applies its
        slice under its own lock and interpreter)."""
        from concurrent.futures import ThreadPoolExecutor

        with self._pool_init_lock:
            pool = self._fan_pool
            if pool is None:
                pool = self._fan_pool = ThreadPoolExecutor(
                    max_workers=max(2, min(self.partitions, 8)),
                    thread_name_prefix="partition-fan")
        return pool

    def _group_by_partition(self, items, key_fn
                            ) -> List[Tuple[int, List[Tuple[int, Any]]]]:
        """[(partition, [(index, item), ...]), ...], each partition's
        items in their order."""
        groups: Dict[int, List[Tuple[int, Any]]] = {}
        for i, item in enumerate(items):
            groups.setdefault(key_fn(item), []).append((i, item))
        return sorted(groups.items())

    def _fan_by_partition(self, items, key_fn, call_fn,
                          _depth: int = 0) -> List[Any]:
        """Split positional ``items`` by partition (``key_fn``), run
        ``call_fn(partition, slice)`` for each group (at once when there
        are several) and merge each slice's positional results back into
        the items' order. A slice refused by a moved-slice 429
        (``StaleRouteError``) splits again alone, against the refreshed
        topology: slices that committed keep their results (sending them
        again would read their own 409s as failures)."""
        groups = self._group_by_partition(items, key_fn)
        retry: List[Tuple[int, Any]] = []
        outs = []
        if len(groups) == 1:
            futures = [(groups[0][1], None)]
        else:
            pool = self._fan_out()
            futures = [(entries, pool.submit(call_fn, p,
                                             [it for _, it in entries]))
                       for p, entries in groups]
        for (entries, fut), (p, _) in zip(futures, groups):
            try:
                got = fut.result() if fut is not None \
                    else call_fn(p, [it for _, it in entries])
                outs.append((entries, got))
            except StaleRouteError:
                if _depth >= 3:
                    raise
                retry.extend(entries)
        results: List[Any] = [None] * len(items)
        for entries, got in outs:
            for (i, _), r in zip(entries, got):
                results[i] = r
        if retry:
            time.sleep(0.05)
            again = self._fan_by_partition(
                [it for _, it in retry], key_fn, call_fn, _depth + 1)
            for (i, _), r in zip(retry, again):
                results[i] = r
        return results

    def _with_resplit(self, fn):
        """Run a bulk fan-out, splitting it again against the refreshed
        topology while a server answers a moved-slice 429. Bounded: a
        topology that never settles surfaces the error."""
        for _ in range(4):
            try:
                return fn()
            except StaleRouteError:
                time.sleep(0.05)
        return fn()

    def check_partition_topology(self) -> None:
        """Each endpoint must serve the partition this client routes to
        it (GET /api/v1/partitiontopology): URLs in the wrong order or of
        the wrong count fail here, not as half-empty partitions."""
        for i in range(self.partitions):
            code, topo = self._request(
                "GET", "/api/v1/partitiontopology", partition=i)
            if code != 200 or not isinstance(topo, dict):
                raise RuntimeError(
                    f"partition {i} topology probe failed: HTTP {code}")
            if topo.get("partition") != i \
                    or topo.get("partitions") != self.partitions:
                raise RuntimeError(
                    f"partition_urls[{i}] ({self.partition_urls[i]}) "
                    f"serves partition {topo.get('partition')} of "
                    f"{topo.get('partitions')}, not {i} of "
                    f"{self.partitions}: misconfigured routing")

    # -- the elastic topology (live resharding) --------------------------
    def enable_topology(self, poll_interval: float = 0.5) -> bool:
        """Switch to epoch-aware routing: fetch the live topology document
        and (``poll_interval`` > 0) start a poller that re-routes this
        client, its watch streams included, whenever
        ``/api/v1/partitiontopology`` changes epoch. False when the
        servers have no live topology (the client stays static)."""
        got = self.refresh_topology()
        if got and poll_interval > 0 and self._topology_thread is None:
            self._topology_stop.clear()
            self._topology_thread = threading.Thread(
                target=self._topology_poll_loop, args=(poll_interval,),
                daemon=True, name="topology-poll")
            self._topology_thread.start()
        return got

    def stop_topology_watch(self) -> None:
        self._topology_stop.set()
        t, self._topology_thread = self._topology_thread, None
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)

    def _topology_poll_loop(self, interval: float) -> None:
        offset = 0
        while not self._topology_stop.wait(interval):
            # round-robin the endpoints: partition 0 may be the one that
            # just died (a failover is when the topology changes)
            for i in range(len(self._endpoints)):
                p = (offset + i) % len(self._endpoints)
                try:
                    self.refresh_topology(partition=p, replumb=True)
                    break   # a server answered
                except Exception:  # noqa: BLE001 — dead endpoint: next
                    continue
            offset += 1

    def refresh_topology(self, partition: int = 0,
                         replumb: bool = True) -> bool:
        """Fetch the topology document from one endpoint and apply it if
        its epoch is newer. ``replumb=False`` updates the routing only
        (a 429's refresh runs on any thread; the watch streams' surgery
        belongs to the poller)."""
        code, doc = self._request("GET", "/api/v1/partitiontopology",
                                  partition=partition, retries=0)
        if code != 200 or not isinstance(doc, dict) \
                or "owner" not in doc:
            return False
        self._apply_topology(PartitionTopology.from_dict(doc),
                             replumb=replumb)
        return True

    def apply_topology(self, topo: PartitionTopology,
                       replumb: bool = True) -> None:
        """Install a topology directly (a coordinator that has just
        committed a migration hands it over without waiting a poll)."""
        self._apply_topology(topo, replumb=replumb)

    def _apply_topology(self, topo: PartitionTopology,
                        replumb: bool) -> None:
        """Install the routing of a newer epoch (any thread) and, for a
        replumbing caller (the poller, a coordinator), bring the watch
        streams up to whatever epoch the routing has reached. The two
        are tracked apart (``_replumb_epoch``): a routing-only install
        must not let the streams' catch-up be lost to an equal epoch."""
        do_streams = False
        changed: set = set()
        gained: set = set()
        with self._topology_lock:
            if self._topology is None or topo.epoch > self.topology_epoch:
                self._install_routing_locked(topo)
            if replumb and self._elastic_watching \
                    and self._replumb_epoch < self.topology_epoch:
                do_streams = True
                self._replumb_epoch = self.topology_epoch
                changed, self._pending_changed = \
                    set(self._pending_changed), set()
                gained, self._pending_gained = \
                    set(self._pending_gained), set()
                topo = self._topology
        if do_streams:
            self._replumb_streams(topo, changed, gained)

    def _install_routing_locked(self, topo: PartitionTopology) -> None:
        """Under ``_topology_lock``: the routing tables, the pools and the
        version watchdog of a newer epoch."""
        old_urls = list(self.partition_urls)
        old_topo = self._topology
        new_urls = [u.rstrip("/") for u in topo.urls] \
            if topo.urls else old_urls
        # the partitions that gained keyspace: a changed spread set can
        # land a namespace's keys anywhere (slots by name), so every
        # partition gains; an owner change gains the slots' new owners
        if old_topo is not None:
            if topo.spread != old_topo.spread:
                self._pending_gained |= set(range(len(new_urls)))
            else:
                for slot, owner in enumerate(topo.owner):
                    if slot >= len(old_topo.owner) \
                            or old_topo.owner[slot] != owner:
                        self._pending_gained.add(owner)
        changed = {p for p in range(len(new_urls))
                   if p >= len(old_urls) or new_urls[p] != old_urls[p]}
        endpoints = []
        for u in new_urls:
            host, _, port = u.split("://", 1)[1].partition(":")
            endpoints.append((host, int(port or 80)))
        for p in changed:
            host, port = endpoints[p]
            for lane in ("ro", "rw"):
                old_pool = self._pools.get((p, lane))
                if old_pool is not None:
                    old_pool.close_all()
                self._pools[(p, lane)] = _ConnPool(host, port)
        self.partition_urls = new_urls
        self.partitions = len(new_urls)
        self._endpoints = endpoints
        self._topology = topo
        self.topology_epoch = topo.epoch
        self._pending_changed |= changed
        # the version watchdog is keyed by (kind, partition index); a
        # changed index is another server now (a split's new process, a
        # restart with a restored store), whose first list must not read
        # as a regression of its predecessor's versions
        with self._rv_lock:
            for key in [k for k in self._last_rv if k[1] in changed]:
                del self._last_rv[key]
        # a changed index is a restart seam: the pin belonged to the old
        # server, and the new server's first echo is a re-negotiation
        with self._codec_lock:
            for p in changed:
                if self.negotiated_codec.pop(p, None) is not None:
                    self._codec_pending_reneg.add(p)

    def bind_many(self, bindings: List[Tuple[str, str, str, str]]
                  ) -> List[Optional[Exception]]:
        """Bulk POST /bindings: (namespace, name, uid, node) each, one
        token a binding, failures back positionally (KeyError for a
        missing pod, ValueError for a conflict) — the contract of
        ``store.bind_many``. Split by partition; past ``_BIND_SPLIT`` a
        partition's slice goes out as two pipelined halves."""
        if not bindings:
            return []
        return self._with_resplit(lambda: self._fan_by_partition(
            list(bindings), lambda b: self._pk("Pod", b[0], b[1]),
            self._bind_partition))

    def _bind_partition(self, partition: int,
                        bindings: List[Tuple[str, str, str, str]]
                        ) -> List[Optional[Exception]]:
        if len(bindings) > self._BIND_SPLIT:
            from concurrent.futures import ThreadPoolExecutor

            with self._pool_init_lock:
                pool = self._bind_pool
                if pool is None:
                    pool = self._bind_pool = ThreadPoolExecutor(
                        max_workers=2, thread_name_prefix="bind-many")
            mid = len(bindings) // 2
            left = pool.submit(self._bind_chunk, bindings[:mid], partition)
            right = self._bind_chunk(bindings[mid:], partition)
            return left.result() + right
        return self._bind_chunk(bindings, partition)

    def _bind_chunk(self, bindings: List[Tuple[str, str, str, str]],
                    partition: int) -> List[Optional[Exception]]:
        if self.binary:
            payload: Any = {"kind": "BindingList",
                            "items": [tuple(b) for b in bindings]}
        else:
            payload = {"kind": "BindingList", "items": [
                {"namespace": ns, "name": n, "uid": u,
                 "target": {"name": node}}
                for ns, n, u, node in bindings]}
        code, resp = self._request("POST", "/api/v1/bindings", payload,
                                   charge=len(bindings),
                                   trace_ctx=self._trace_ctx_for(
                                       [b[2] for b in bindings]),
                                   partition=partition,
                                   raise_on_stale=self._topology
                                   is not None)
        if code >= 400:
            err = RuntimeError(
                resp.get("message", f"HTTP {code}")
                if isinstance(resp, dict) else f"HTTP {code}")
            return [err] * len(bindings)
        errors: List[Optional[Exception]] = [None] * len(bindings)
        for f in resp.get("failures", ()):
            exc = KeyError(f["message"]) if f.get("code") == 404 \
                else ValueError(f["message"])
            errors[f["index"]] = exc
        return errors

    # -- pod status writes ---------------------------------------------
    def _put_status(self, namespace: str, name: str, status: dict) -> None:
        buf = getattr(self._status_buffers, "buf", None)
        if buf is not None:
            # inside a batched_status_writes scope: coalesce — the
            # items apply in order at scope exit as ONE bulk request
            buf.append({"namespace": namespace, "name": name,
                        "status": status})
            return
        code, payload = self._request(
            "PUT", self._path("Pod", namespace, name, "status"),
            {"status": status}, body_binary=False,
            trace_ctx=self._trace_ctx_for([f"{namespace}/{name}"]),
            route=lambda: self._pk("Pod", namespace, name))
        if code == 404:
            return   # pod deleted under us: store semantics are no-op
        self._raise_for(code, payload)

    def write_pod_statuses(self, updates: List[dict]
                           ) -> List[Optional[Exception]]:
        """Bulk POST /api/v1/statuses (PodStatusList): N status writes
        in one round trip a partition, positional failures. Each item is
        ``{"namespace", "name", "status": {...}}`` with the exact
        per-item semantics of PUT pods/{name}/status; the token bucket
        charges per ITEM. 404s are None (pod deleted under us), as in
        ``_put_status``."""
        if not updates:
            return []
        return self._with_resplit(lambda: self._fan_by_partition(
            list(updates),
            lambda u: self._pk("Pod", u.get("namespace"), u.get("name")),
            self._statuses_partition))

    def _statuses_partition(self, partition: int, updates: List[dict]
                            ) -> List[Optional[Exception]]:
        code, resp = self._request(
            "POST", "/api/v1/statuses",
            {"kind": "PodStatusList", "items": updates},
            charge=len(updates), body_binary=False,
            trace_ctx=self._trace_ctx_for(
                [f"{u.get('namespace')}/{u.get('name')}"
                 for u in updates]),
            partition=partition,
            raise_on_stale=self._topology is not None)
        if code >= 400:
            err = RuntimeError(
                resp.get("message", f"HTTP {code}")
                if isinstance(resp, dict) else f"HTTP {code}")
            return [err] * len(updates)
        errors: List[Optional[Exception]] = [None] * len(updates)
        for f in resp.get("failures", ()):
            if f.get("code") == 404:
                continue   # pod deleted under us: single-PUT no-op
            errors[f["index"]] = PermissionError(f["message"]) \
                if f.get("code") in (403, 422) \
                else RuntimeError(f["message"])
        return errors

    def batched_status_writes(self):
        """Scope that coalesces this THREAD's pod-status writes
        (conditions, nominatedNodeName, phase) into one bulk
        ``/statuses`` request flushed at exit: the mass-decline path
        writes thousands of PodScheduled=False conditions a batch.
        Writes become visible at scope exit."""
        import contextlib

        @contextlib.contextmanager
        def scope():
            if getattr(self._status_buffers, "buf", None) is not None:
                # nested scope: the outer one owns the flush
                yield
                return
            buf: List[dict] = []
            self._status_buffers.buf = buf
            try:
                yield
            finally:
                self._status_buffers.buf = None
                if buf:
                    try:
                        self.write_pod_statuses(buf)
                    except Exception:  # noqa: BLE001 — best-effort,
                        # like the per-object writes it replaces
                        pass

        return scope()

    def patch_pod_condition(self, namespace: str, name: str,
                            condition) -> None:
        self._put_status(namespace, name, {"conditions": [{
            "type": condition.type, "status": condition.status,
            "reason": condition.reason, "message": condition.message,
        }]})

    def set_nominated_node_name(self, namespace: str, name: str,
                                node: str) -> None:
        self._put_status(namespace, name, {"nominatedNodeName": node})

    def clear_nominated_node_name(self, namespace: str, name: str) -> None:
        self._put_status(namespace, name, {"nominatedNodeName": ""})

    def delete_pod(self, namespace: str, name: str) -> None:
        code, payload = self._request(
            "DELETE", self._path("Pod", namespace, name),
            trace_ctx=self._trace_ctx_for([f"{namespace}/{name}"]),
            route=lambda: self._pk("Pod", namespace, name))
        if code >= 400 and code != 404:
            self._raise_for(code, payload)

    def delete_pods(self, keys: List[Tuple[str, str]]) -> None:
        for namespace, name in keys:
            self.delete_pod(namespace, name)

    # -- PV binding: the volume binder's assume cache is store-local
    def assume_pv_bound(self, pv_name: str, pvc_key: str) -> None:
        raise NotImplementedError(
            "assume_pv_bound is store-local; run PV-assume workloads "
            "against the in-process store")

    def revert_assumed_pv(self, pv_name: str) -> None:
        raise NotImplementedError("see assume_pv_bound")

    def bind_pv(self, pv_name: str, pvc_namespace: str,
                pvc_name: str) -> bool:
        raise NotImplementedError("see assume_pv_bound")

    def unbind_pv(self, pv_name: str, pvc_namespace: str,
                  pvc_name: str) -> None:
        raise NotImplementedError("see assume_pv_bound")

    # -- generic objects and Events ------------------------------------
    def create_objects_bulk(self, kind: str, objs: List[Any]) -> int:
        """POST a {Kind}List (one a partition, at once); a taken name is
        skipped (a 409 item). Returns how many were created."""
        if not objs:
            return 0

        def create(partition: int, items: List[Any]) -> List[int]:
            # a slice's count at its first item's place, 0 at the rest
            return [self._create_list(kind, items, partition)] + \
                [0] * (len(items) - 1)

        return sum(self._with_resplit(lambda: self._fan_by_partition(
            list(objs), lambda o: self._pk(
                kind, getattr(o.metadata, "namespace", None),
                o.metadata.name), create)))

    def _create_list(self, kind: str, objs: List[Any], partition: int
                     ) -> int:
        # a batch spanning namespaces POSTs the cluster-scoped
        # collection (the path namespace overrides per-item namespaces
        # server-side)
        ns = getattr(objs[0].metadata, "namespace", None)
        if ns is not None and any(
                getattr(o.metadata, "namespace", None) != ns
                for o in objs):
            ns = None
        payload = {"kind": f"{kind}List",
                   "items": objs if self.binary
                   else [to_wire(o) for o in objs]}
        code, resp = self._request(
            "POST", self._path(kind, ns), payload, charge=len(objs),
            trace_ctx=self._trace_ctx_for(
                [getattr(o.metadata, "uid", "") for o in objs]),
            partition=partition,
            raise_on_stale=self._topology is not None)
        self._raise_for(code, resp)
        return resp.get("created", 0)

    def update_object(self, kind: str, obj,
                      expect_rv: Optional[str] = None) -> Any:
        ns = getattr(obj.metadata, "namespace", None)
        code, payload = self._request(
            "PUT", self._path(kind, ns, obj.metadata.name),
            obj if self.binary else to_wire(obj),
            route=lambda: self._pk(kind, ns, obj.metadata.name))
        self._raise_for(code, payload)
        return obj

    def create_object(self, kind: str, obj) -> Any:
        ns = getattr(obj.metadata, "namespace", None)
        code, payload = self._request(
            "POST", self._path(kind, ns),
            obj if self.binary else to_wire(obj),
            trace_ctx=self._trace_ctx_for(
                [getattr(obj.metadata, "uid", "")
                 or f"{ns}/{obj.metadata.name}"]),
            route=lambda: self._pk(kind, ns, obj.metadata.name))
        self._raise_for(code, payload)
        return obj

    def create_pod(self, pod) -> Any:
        """One pod (the kubelet's mirror pod)."""
        return self.create_object("Pod", pod)

    def set_pod_phase(self, namespace: str, name: str, phase: str,
                      pod_ip: str = "", host_ip: str = "") -> bool:
        """The kubelet's status write (PUT pods/{name}/status); False when
        the pod is gone."""
        status: Dict[str, Any] = {}
        if phase:
            status["phase"] = phase
        if pod_ip:
            status["podIP"] = pod_ip
        if host_ip:
            status["hostIP"] = host_ip
        code, payload = self._request(
            "PUT", self._path("Pod", namespace, name, "status"),
            {"status": status}, body_binary=False,
            trace_ctx=self._trace_ctx_for([f"{namespace}/{name}"]),
            route=lambda: self._pk("Pod", namespace, name))
        if code == 404:
            return False
        self._raise_for(code, payload)
        return True

    def list_objects(self, kind: str, namespace: Optional[str] = None
                     ) -> List[Any]:
        return self._list(kind, namespace)

    def get_object(self, kind: str, namespace: str, name: str):
        return self._get(kind, namespace if namespace else None, name)

    def create_events(self, events: List[Any]) -> int:
        return self.create_objects_bulk("Event", events)

    def get_event(self, namespace: str, name: str) -> Optional[Any]:
        return self._get("Event", namespace, name)

    def update_event(self, ev) -> Any:
        return self.update_object("Event", ev)

    def prune_expired_events(self, now: Optional[float] = None) -> int:
        return 0   # the server's Event TTL owns expiry over REST

    # -- list, then watch ------------------------------------------------
    def list_for_watch(self) -> Dict[str, Tuple[List[Any], Any]]:
        """Every watched kind's list and the resourceVersion it is
        consistent at: what ``watch(..., resume=)`` streams on from. A
        partition-aware client lists each partition and gives the
        per-partition versions as a ``CompositeCursor``."""
        if self.partitions == 1:
            return {kind: self._list_with_rv(kind, partition=0)
                    for kind in self.watch_kinds}
        out: Dict[str, Tuple[List[Any], Any]] = {}
        for kind in self.watch_kinds:
            parts = self._pset(kind)
            got = self._fan_out().map(
                lambda p, kind=kind: self._list_with_rv(kind, partition=p),
                parts)
            objs: List[Any] = []
            rvs = [0] * self.partitions
            for p, (items, rv) in zip(parts, got):
                objs.extend(items)
                rvs[p] = rv
            out[kind] = (objs, CompositeCursor(rvs))
        return out

    def _resume_for(self, kind: str, partition: int, resume
                    ) -> Optional[Tuple[List[Any], int]]:
        """Partition ``partition``'s slice of ``list_for_watch``'s list
        of ``kind``, and its version."""
        if not resume or kind not in resume:
            return None
        objs, rv = resume[kind]
        if not isinstance(rv, CompositeCursor):
            return objs, rv
        return ([o for o in objs
                 if self._pk(kind, getattr(o.metadata, "namespace", None),
                             o.metadata.name) == partition],
                rv.component(partition))

    def watch(self, batch_fn: Callable[[List[Event]], None],
              resume: Optional[Dict[str, Tuple[List[Any], int]]] = None
              ) -> _WatchHandle:
        """Watch every scheduler kind over chunked HTTP, one stream a
        kind, delivering each decoded frame (a server-coalesced batch)
        in one ``batch_fn`` call, as the store's watch does. Each
        stream starts at the version of ``resume`` (``list_for_watch``'s
        lists) and delivers nothing that list holds; without ``resume``
        the lists are taken here, before the call returns, so every
        write after it is delivered, as from the store's watch. A stream
        that drops relists and delivers the difference against what it
        has delivered."""
        if resume is None:
            resume = self.list_for_watch()
        self._stopping.clear()
        if self._topology is not None:
            # elastic: restartable streams a (kind, partition) whose
            # reflector state this client holds, so an epoch change hands
            # a moved slice to its new partition's stream and relists
            # nothing that did not move
            self._elastic_watching = True
            self._watch_batch_fn = batch_fn
            with self._handoff_lock:
                for kind in self.watch_kinds:
                    for p in self._pset(kind):
                        self._start_stream(
                            kind, p, handoff=False,
                            initial=self._resume_for(kind, p, resume))
            return _WatchHandle(self)
        for kind in self.watch_kinds:
            for p in self._pset(kind):
                t = threading.Thread(
                    target=self._watch_loop,
                    args=(kind, p, batch_fn,
                          self._resume_for(kind, p, resume)),
                    daemon=True, name=f"watch-{kind}-p{p}")
                t.start()
                self._watch_threads.append(t)
        return _WatchHandle(self)

    def _stop_watches(self) -> None:
        self._stopping.set()
        self._elastic_watching = False
        self._watch_batch_fn = None
        for ev in list(self._stream_stops.values()):
            ev.set()
        with self._pool_init_lock:
            conns = list(self._stream_conns.values())
            self._stream_conns.clear()
        for conn in conns:
            _sever(conn)
        self.stop_topology_watch()

    # -- elastic watch streams (the cursor-keeping handoff) ---------------
    def _start_stream(self, kind: str, p: int, handoff: bool,
                      initial: Optional[Tuple[List[Any], int]] = None
                      ) -> None:
        """Start (or replace) the stream of one (kind, partition). A
        ``handoff`` stream starts mid-run after a topology change: its
        first list delivers the difference against the (transferred)
        known map, the window the consumer missed, where a boot stream's
        first list (or ``initial``, ``list_for_watch``'s slice) is only
        remembered."""
        old_stop = self._stream_stops.get((kind, p))
        if old_stop is not None:
            old_stop.set()
        with self._pool_init_lock:
            old_conn = self._stream_conns.pop((kind, p), None)
        _sever(old_conn)
        stop = threading.Event()
        self._stream_stops[(kind, p)] = stop
        t = threading.Thread(
            target=self._watch_elastic_loop,
            args=(kind, p, stop, handoff, initial),
            daemon=True, name=f"watch-{kind}-p{p}")
        t.start()
        self._watch_threads.append(t)

    def _deliver(self, kind: str, p: int, events: List[Event]) -> None:
        """Forward events to the consumer through the stream's known map,
        with a version filter an object: an event replayed past the
        handoff seam, or a late delivery a catch-up fetch already
        superseded, is dropped (never duplicated, never backwards)."""
        topo = self._topology
        out: List[Event] = []
        with self._known_lock:
            known = self._stream_known.setdefault((kind, p), {})
            for e in events:
                key = _key_of(e.obj)
                rv = _rv_of(e.obj)
                prev = known.get(key)
                prev_rv = _rv_of(prev) if prev is not None else -1
                if prev is None and topo is not None \
                        and topo.partition_of(kind, key[0], key[1]) != p:
                    # a key this stream neither owns nor has state for:
                    # a late delivery from before the transfer (its new
                    # owner's catch-up covers it) or an early one from
                    # after the flip (the owner's stream delivers it).
                    # Forwarding it would deliver it twice
                    continue
                if e.type == DELETED:
                    if prev is None or (rv and prev_rv > rv):
                        continue
                    known.pop(key, None)
                else:
                    if prev is not None and rv and prev_rv >= rv:
                        continue
                    known[key] = e.obj
                out.append(e)
        batch_fn = self._watch_batch_fn
        if out and batch_fn is not None:
            batch_fn(out)

    def _endpoint(self, p: int) -> Optional[Tuple[str, int]]:
        endpoints = self._endpoints
        return endpoints[p] if p < len(endpoints) else None

    def _watch_elastic_loop(self, kind: str, p: int,
                            stop: threading.Event, handoff: bool,
                            initial: Optional[Tuple[List[Any], int]]
                            ) -> None:
        from kubernetes_tpu_torch.metrics.fabric_metrics import (
            fabric_metrics,
        )

        first = True
        # the endpoint this stream was plumbed against: when it changes
        # the partition's process was replaced, and the seam belongs to
        # ``_replumb_streams``, which stops this loop and opens a handoff
        # stream (reconnecting here would count the restart as a relist
        # of an unmoved slice)
        ep0 = self._endpoint(p)
        while not self._stopping.is_set() and not stop.is_set():
            if self._endpoint(p) != ep0:
                return
            try:
                if first and initial is not None:
                    objs, rv = initial
                else:
                    objs, rv = self._list_with_rv(kind, partition=p)
                if stop.is_set() or self._stopping.is_set() \
                        or self._endpoint(p) != ep0:
                    return
                live = {_key_of(o): o for o in objs}
                events: List[Event] = []
                if first and not handoff:
                    # a boot stream: the consumer replays the first list
                    # itself; remember what exists
                    with self._known_lock:
                        self._stream_known.setdefault(
                            (kind, p), {}).update(live)
                else:
                    with self._known_lock:
                        snapshot = dict(self._stream_known.setdefault(
                            (kind, p), {}))
                    events = replace_diff(kind, snapshot, live)
                    if first:
                        self.handoff_fetches += 1
                    else:
                        # a torn stream relists its own slice only
                        fabric_metrics().client_relists_total.inc(kind)
                        self.stream_relists[(kind, p)] = \
                            self.stream_relists.get((kind, p), 0) + 1
                first = False
                if events:
                    self._deliver(kind, p, events)
                self._stream_watch(
                    kind, rv, lambda evs: self._deliver(kind, p, evs), p,
                    stop=stop)
            except (http.client.HTTPException, OSError, RuntimeError):
                pass
            if self._stopping.is_set() or stop.is_set():
                return
            time.sleep(0.2)   # relist and watch again

    def _reconcile_stream(self, kind: str, p: int,
                          keys: List[tuple]) -> None:
        """Catch up keys just transferred into partition p's live stream
        (a move to an existing partition, a retire draining into the
        survivors): list p once and deliver the difference. The live
        stream covers what p commits after the flip; this covers the
        window before it that the source's stream may not have
        delivered. Additions and updates come from the whole list (a
        write of the freeze window the source never delivered is in no
        known map); deletions only for the transferred ``keys`` (a
        whole-list diff would race the live stream into a false
        DELETED). The known map is read before the list, so what lands
        between shows up as a duplicate the version filter drops."""
        self.handoff_fetches += 1
        with self._known_lock:
            snapshot = dict(self._stream_known.setdefault((kind, p), {}))
        try:
            objs, _rv = self._list_with_rv(kind, partition=p)
        except (http.client.HTTPException, OSError, RuntimeError):
            return
        live = {_key_of(o): o for o in objs}
        events: List[Event] = []
        for key, cur in live.items():
            old = snapshot.get(key)
            if old is None:
                events.append(Event(ADDED, kind, cur))
            elif _rv_of(old) != _rv_of(cur):
                events.append(Event(MODIFIED, kind, cur, old))
        for key in keys:
            if key not in live and key in snapshot:
                events.append(Event(DELETED, kind, snapshot[key]))
        if events:
            self._deliver(kind, p, events)

    def _replumb_streams(self, topo: PartitionTopology, changed_urls: set,
                         gained: Optional[set] = None) -> None:
        """Re-route the watch streams after an epoch change:

        1. stop the streams whose partition left the fan set (retired) or
           whose endpoint changed (a restart), and let their delivery
           drain;
        2. move each stopped or moved key's known entry to its new
           owner's map (the client's half of the cursor transfer);
        3. start handoff streams where the fan set lacks one (a split's
           new partition, a restarted endpoint): their first list
           delivers the missed window as a difference;
        4. catch up the live streams that gained keyspace, whether or
           not a known key moved with it.

        The streams of unmoved slices are not touched: no relist."""
        gained = gained or set()
        with self._handoff_lock:
            fan: Dict[str, set] = {
                kind: set(topo.partitions_for(kind))
                for kind in self.watch_kinds}
            stopped: List[Tuple[str, int]] = []
            for (kind, p) in list(self._stream_stops):
                if kind not in fan:
                    continue
                if p not in fan[kind] or p in changed_urls:
                    ev = self._stream_stops.get((kind, p))
                    if ev is not None:
                        ev.set()
                    with self._pool_init_lock:
                        conn = self._stream_conns.pop((kind, p), None)
                    _sever(conn)
                    stopped.append((kind, p))
            if stopped:
                time.sleep(0.05)   # let their delivery drain
            to_reconcile: Dict[Tuple[str, int], List[tuple]] = {}
            with self._known_lock:
                for (kind, p), known in list(self._stream_known.items()):
                    if kind not in fan:
                        continue
                    for key in list(known):
                        q = topo.partition_of(kind, key[0], key[1])
                        if q == p:
                            # same owner: a stopped stream's restarted
                            # handoff stream diffs it
                            continue
                        obj = known.pop(key)
                        self._stream_known.setdefault(
                            (kind, q), {})[key] = obj
                        to_reconcile.setdefault((kind, q), []).append(key)
            started: set = set()
            for kind in self.watch_kinds:
                for q in fan[kind]:
                    ev = self._stream_stops.get((kind, q))
                    if ev is None or ev.is_set():
                        self._start_stream(kind, q, handoff=True)
                        started.add((kind, q))
            for kind in self.watch_kinds:
                for q in gained & fan[kind]:
                    to_reconcile.setdefault((kind, q), [])
            for (kind, q), keys in to_reconcile.items():
                if (kind, q) not in started:
                    self._reconcile_stream(kind, q, keys)

    def _watch_loop(self, kind: str, partition: int, batch_fn,
                    initial: Optional[Tuple[List[Any], int]]) -> None:
        # objects this stream has shown the consumer, for a relist's
        # diff after a dropped stream (of this partition's slice only):
        # (ns, name) -> last-seen object
        known: Dict[tuple, Any] = {}

        def deliver(events: List[Event]) -> None:
            for e in events:
                if e.type == DELETED:
                    known.pop(_key_of(e.obj), None)
                else:
                    known[_key_of(e.obj)] = e.obj
            batch_fn(events)

        first = True
        while not self._stopping.is_set():
            try:
                if first and initial is not None:
                    objs, rv = initial
                else:
                    objs, rv = self._list_with_rv(kind, partition=partition)
                if first:
                    # the consumer replays the first list itself; this
                    # stream only has to remember what exists
                    known.update((_key_of(o), o) for o in objs)
                    first = False
                else:
                    from kubernetes_tpu_torch.metrics.fabric_metrics import (
                        fabric_metrics,
                    )

                    fabric_metrics().client_relists_total.inc(kind)
                    events = replace_diff(
                        kind, dict(known), {_key_of(o): o for o in objs})
                    if events:
                        deliver(events)
                self._stream_watch(kind, rv, deliver, partition)
            except (http.client.HTTPException, OSError, RuntimeError):
                pass
            if self._stopping.is_set():
                return
            time.sleep(0.2)   # relist and watch again

    def _stream_watch(self, kind: str, rv: int, deliver,
                      partition: int = 0,
                      stop: Optional[threading.Event] = None) -> None:
        plural = KIND_TO_PLURAL.get(kind, kind.lower() + "s")
        host, port = self._endpoints[partition]
        conn = http.client.HTTPConnection(host, port, timeout=300)
        conn.connect()
        conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        key = (kind, partition)
        with self._pool_init_lock:
            self._stream_conns[key] = conn
        if self._stopping.is_set() or (stop is not None and stop.is_set()):
            _sever(conn)
        headers = {"Accept": codec.BINARY_CONTENT_TYPE,
                   codec.VERSION_HEADER: str(self.codec_version)}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        tracer = get_tracer()
        if tracer.enabled:
            # an explicitly UNSAMPLED context (a control-plane call, not
            # a pod trace): the server never opens a span for it
            headers[TRACE_HEADER] = format_trace_header(
                f"watch:{kind}", tracer.current_span_id(), False)
        try:
            conn.request(
                "GET", f"/api/v1/{plural}?watch=1&resourceVersion={rv}",
                headers=headers)
            resp = conn.getresponse()
            self._record_negotiated(partition, resp)
            if resp.status != 200:
                resp.read()
                if resp.status == 410:
                    # expired resourceVersion: the caller's relist is
                    # the recovery; count it
                    self._note_retry("WATCH", "http_410")
                return
            while not self._stopping.is_set() \
                    and (stop is None or not stop.is_set()):
                try:
                    batch = codec.read_frame(resp)
                except Exception:  # noqa: BLE001 — torn outer frame
                    return
                if batch is None:
                    return
                # a coalesced chunk carries per-event pickles; the 4th
                # element is the commit timestamp, or (timestamp, origin
                # trace context); legacy 3-tuples decode with no stamp.
                # Scoped to decoding: a consumer error in deliver() must
                # surface, not turn into a relist
                try:
                    events = []
                    for item in batch:
                        if isinstance(item, (bytes, bytearray)):
                            item = codec.decode(item)
                        origin = None
                        if len(item) == 4:
                            t, obj, old, ts = item
                            if isinstance(ts, tuple):
                                ts, origin = ts
                        else:
                            (t, obj, old), ts = item, 0.0
                        events.append(Event(t, kind, obj, old, ts, origin))
                except Exception:  # noqa: BLE001 — torn event
                    return
                if stop is not None and stop.is_set():
                    return   # a stream replumbed away delivers nothing
                self._observe_delivery(kind, events)
                self._trace_watch_delivery(events)
                deliver(events)
        finally:
            with self._pool_init_lock:
                if self._stream_conns.get(key) is conn:
                    self._stream_conns.pop(key, None)
            try:
                conn.close()
            except OSError:
                pass
