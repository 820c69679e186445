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
between the two and none the lists already hold is delivered again.

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
Not here: the elastic topology (re-routing on a topology epoch) and
read replicas.
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
                 partition_urls: Optional[List[str]] = None):
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
        partition-aware; ``base_url`` is then the first."""
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
        # wire-version pin: the codec version this client speaks, stamped
        # on every request; the server echoes the pinned min(server,
        # client)
        self.codec_version = codec.CODEC_VERSION
        self._codec_lock = threading.Lock()
        self.negotiated_codec: Optional[int] = None
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

    def _record_negotiated(self, resp) -> None:
        """Record the server's echoed wire-version pin: a changed echo
        is a re-negotiation (a restarted server behind the URL), an echo
        above our own stamp a contract failure."""
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
            if self.negotiated_codec is not None \
                    and self.negotiated_codec != v:
                self.codec_renegotiations += 1
            self.negotiated_codec = v

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
                 partition: int = 0) -> Tuple[int, Any]:
        """One request to ``partition``'s apiserver with the client's
        discipline: the token bucket charged ``charge`` objects, retries
        on transport errors and on 429/503 (honoring Retry-After, capped
        at ``retry_after_cap``) within the retry budget, the circuit
        breaker fed. The body goes binary unless ``body_binary``
        (default: the client's ``binary``) is False. Returns (status,
        decoded body)."""
        if body_binary is None:
            body_binary = self.binary
        if self.limiter is not None:
            self.limiter.charge(charge)
        data = None
        if payload is not None:
            data = codec.encode(payload) if body_binary \
                else json.dumps(payload).encode()
        pool = self._pools[(partition,
                            "ro" if method in ("GET", "HEAD") else "rw")]
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
                pool.prewarm(1)
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
            self._record_negotiated(resp)
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
        """The partition an object lives in."""
        return partition_for(kind, namespace, name, self.partitions)

    def _list_with_rv(self, kind: str, namespace: Optional[str] = None,
                      partition: Optional[int] = None
                      ) -> Tuple[List[Any], int]:
        """A list and the resourceVersion it is consistent at, from
        ``partition``, or fanned in from every partition the kind can
        live in (the version is then the largest). The monotonicity
        watchdog records a partition's version that went backwards."""
        if partition is None:
            parts = partitions_for(kind, self.partitions, namespace)
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
            partition=self._pk(kind, namespace, name))
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
                                      partition=self._pk("Node", None, name))
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
            body_binary=False, partition=self._pk("Pod", namespace, name))
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

    def _fan_by_partition(self, items, key_fn, call_fn) -> List[Any]:
        """Split positional ``items`` by partition (``key_fn``), run
        ``call_fn(partition, slice)`` for each group (at once when there
        are several) and merge each slice's positional results back into
        the items' order."""
        groups = self._group_by_partition(items, key_fn)
        if len(groups) == 1:
            p, entries = groups[0]
            outs = [(entries, call_fn(p, [it for _, it in entries]))]
        else:
            pool = self._fan_out()
            futures = [(entries, pool.submit(call_fn, p,
                                             [it for _, it in entries]))
                       for p, entries in groups]
            outs = [(entries, fut.result()) for entries, fut in futures]
        results: List[Any] = [None] * len(items)
        for entries, got in outs:
            for (i, _), r in zip(entries, got):
                results[i] = r
        return results

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

    def bind_many(self, bindings: List[Tuple[str, str, str, str]]
                  ) -> List[Optional[Exception]]:
        """Bulk POST /bindings: (namespace, name, uid, node) each, one
        token a binding, failures back positionally (KeyError for a
        missing pod, ValueError for a conflict) — the contract of
        ``store.bind_many``. Split by partition; past ``_BIND_SPLIT`` a
        partition's slice goes out as two pipelined halves."""
        if not bindings:
            return []
        return self._fan_by_partition(
            list(bindings), lambda b: self._pk("Pod", b[0], b[1]),
            self._bind_partition)

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
                                   partition=partition)
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
            partition=self._pk("Pod", namespace, name))
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
        return self._fan_by_partition(
            list(updates),
            lambda u: self._pk("Pod", u.get("namespace"), u.get("name")),
            self._statuses_partition)

    def _statuses_partition(self, partition: int, updates: List[dict]
                            ) -> List[Optional[Exception]]:
        code, resp = self._request(
            "POST", "/api/v1/statuses",
            {"kind": "PodStatusList", "items": updates},
            charge=len(updates), body_binary=False,
            trace_ctx=self._trace_ctx_for(
                [f"{u.get('namespace')}/{u.get('name')}"
                 for u in updates]),
            partition=partition)
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
            partition=self._pk("Pod", namespace, name))
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

        return sum(self._fan_by_partition(
            list(objs), lambda o: self._pk(
                kind, getattr(o.metadata, "namespace", None),
                o.metadata.name), create))

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
            partition=partition)
        self._raise_for(code, resp)
        return resp.get("created", 0)

    def update_object(self, kind: str, obj,
                      expect_rv: Optional[str] = None) -> Any:
        ns = getattr(obj.metadata, "namespace", None)
        code, payload = self._request(
            "PUT", self._path(kind, ns, obj.metadata.name),
            obj if self.binary else to_wire(obj),
            partition=self._pk(kind, ns, obj.metadata.name))
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
            partition=self._pk(kind, ns, obj.metadata.name))
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
            partition=self._pk("Pod", namespace, name))
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
            parts = partitions_for(kind, self.partitions)
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
        in one ``batch_fn`` call, as the store's watch does. With
        ``resume`` (``list_for_watch``'s lists) each stream starts at
        its list's version and delivers nothing that list holds;
        without it each stream lists first and delivers only what
        follows. A stream that drops relists and delivers the
        difference against what it has delivered."""
        self._stopping.clear()
        for kind in self.watch_kinds:
            for p in partitions_for(kind, self.partitions):
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
        with self._pool_init_lock:
            conns = list(self._stream_conns.values())
            self._stream_conns.clear()
        for conn in conns:
            _sever(conn)

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
                      partition: int = 0) -> None:
        plural = KIND_TO_PLURAL.get(kind, kind.lower() + "s")
        host, port = self._endpoints[partition]
        conn = http.client.HTTPConnection(host, port, timeout=300)
        conn.connect()
        conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        key = (kind, partition)
        with self._pool_init_lock:
            self._stream_conns[key] = conn
        if self._stopping.is_set():
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
            self._record_negotiated(resp)
            if resp.status != 200:
                resp.read()
                if resp.status == 410:
                    # expired resourceVersion: the caller's relist is
                    # the recovery; count it
                    self._note_retry("WATCH", "http_410")
                return
            while not self._stopping.is_set():
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
