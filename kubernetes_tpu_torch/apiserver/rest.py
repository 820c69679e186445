"""HTTP REST API server + remote client.

The process-boundary surface of the port: kube-apiserver's endpoint
layer over the port's ``ClusterStore``, with the JAX package's routes,
status codes and JSON bodies:

- handler chain per request: flow-control admission (API Priority &
  Fairness, ``apiserver/flowcontrol.py`` — FlowSchemas route identities
  to priority levels with shuffle-sharded fair queues and seat/width
  accounting; the legacy readonly/mutating max-in-flight lanes remain
  behind ``flow_control=None``) → authenticate → authorize → (mutating
  requests) admission → registry operation against the cluster store
- resource routes ``/api/v1/<plural>``, ``/api/v1/namespaces/{ns}/<plural>``,
  object routes ``.../{name}``, subresources ``.../pods/{name}/binding``
  and ``.../pods/{name}/status``
- watches: ``GET ...?watch=true&resourceVersion=N`` streams chunked
  frames, replaying from N via the revisioned watch cache — the same
  List+Watch contract client-go reflectors consume. A compacted N returns
  HTTP 410 Gone ("Expired"), telling the client to relist. Delivery is
  PIPELINED: events are coalesced per chunk (binary clients get one
  length-prefixed frame carrying a batch of per-event pickles, cached so
  N watchers never pay N encodes; JSON clients get several newline-
  delimited ``{"type": ..., "object": {...}}`` documents per chunk), with
  a small flush window so informer catch-up on 30k pods costs
  O(batches) syscalls, not O(pods).
- bulk hot-path verbs: POST ``{Kind}List`` to a collection,
  POST ``/api/v1/bindings`` (BindingList), and POST ``/api/v1/statuses``
  (PodStatusList) apply N objects per request with positional failures —
  per-object semantics, per-batch wire cost.
- ``/healthz`` ``/livez`` ``/readyz`` probes and Prometheus ``/metrics``
  — all exempt from flow control (a liveness probe must never be queued
  or 429'd), like the ``/debug/*`` admin routes: ``/debug/apf``
  (flow-control introspection), ``/debug/slo`` (live SLO evaluation),
  ``/debug/trace`` (the flight recorder) and ``/debug/faults`` (the
  fault gate, off by default)

Transport negotiates per request between JSON over HTTP/1.1 chunked
streams (the kubectl/debug wire, ``kubernetes_tpu_torch.api.serialization``)
and the binary codec (``kubernetes_tpu_torch.apiserver.codec``), which
control-plane clients use for every hot-path payload. Per-request overhead is
amortized server-side too: selector-free binary list responses are
served from a per-kind pre-encoded cache, and authn/authz resolution
sits behind a decision cache invalidated by RBAC object events.

A server may be one partition of the partitioned control plane
(``APIServer(partition=(index, count))``, ``apiserver/partition.py``): its
store holds only that partition's keyspace, and the exempt
``/api/v1/partitiontopology`` document names the partition, so a
partition-aware client checks its routing against it. Once a live
topology is installed (``install_topology``, epochs only increase) the
document carries it whole, every mutation passes the reshard gate (a
frozen slice answers 429 with the freeze's Retry-After, a slice this
server no longer owns 429 with ``X-Partition-Epoch``), and
``/debug/partition`` is the surface ``apiserver/reshard.py`` drives:
freeze, unfreeze, topology, slice, adopt, evict, evict_unowned.

A server may also be a read replica of one partition
(``APIServer(read_only=True)``, ``apiserver/readtier.py``): it serves
lists and watches from a mirror store, answers every mutating verb 503
with ``X-Replica-ReadOnly``, and while ``fenced`` (its replication lag
over budget) answers reads 503 with ``X-Replica-Fenced`` and closes its
live watch streams. Its owner serves the commit stream replicas follow,
``/api/v1/subscription``: every event of every kind as NDJSON frames,
resumed from a resourceVersion through the watch cache or, past it, the
WAL (``wal_dir``), or a snapshot with ``?snapshot=1``.

Not served here: admission webhooks, custom resources, versioned group
routes (every kind is served at ``v1`` only), service-account tokens
and client certificates, pods' exec, log and port-forward
subresources, Service cluster IP allocation and JSON Patch.
"""

from __future__ import annotations

import json
import queue
import socket
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from kubernetes_tpu_torch.api.serialization import from_wire, is_namespaced, to_wire
from kubernetes_tpu_torch.apiserver.faults import FaultGate, resource_of
from kubernetes_tpu_torch.apiserver.flowcontrol import (
    FlowController,
    LaneStats,
    Rejected,
    default_config,
    namespace_of,
)
from kubernetes_tpu_torch.apiserver.admission import (
    CREATE,
    DELETE,
    UPDATE,
    AdmissionChain,
    AdmissionError,
    AdmissionRequest,
)
from kubernetes_tpu_torch.apiserver.store import (
    ClusterStore,
    ConflictError,
    Event,
)
from kubernetes_tpu_torch.apiserver.watchcache import TooOldResourceVersion, WatchCache

# plural route segment ↔ kind
PLURALS: Dict[str, str] = {
    "pods": "Pod",
    "nodes": "Node",
    "services": "Service",
    "endpoints": "Endpoints",
    "replicasets": "ReplicaSet",
    "replicationcontrollers": "ReplicationController",
    "statefulsets": "StatefulSet",
    "persistentvolumeclaims": "PersistentVolumeClaim",
    "persistentvolumes": "PersistentVolume",
    "storageclasses": "StorageClass",
    "csinodes": "CSINode",
    "poddisruptionbudgets": "PodDisruptionBudget",
    "events": "Event",
    "namespaces": "Namespace",
    "resourcequotas": "ResourceQuota",
    "serviceaccounts": "ServiceAccount",
    "roles": "Role",
    "clusterroles": "ClusterRole",
    "rolebindings": "RoleBinding",
    "clusterrolebindings": "ClusterRoleBinding",
    "secrets": "Secret",
    "configmaps": "ConfigMap",
    "priorityclasses": "PriorityClass",
    "leases": "Lease",
}
KIND_TO_PLURAL = {k: p for p, k in PLURALS.items()}

# pipelined watch delivery: after the first event of a binary chunk,
# wait up to this long for more, so a steady producer (informer
# catch-up, bulk creates) ships hundreds of events per syscall
WATCH_FLUSH_WINDOW = 0.002
# the frames a stream may hold unsent before its reader counts as slow
# and the stream is cut: a watcher's, and a read replica's subscription
WATCH_QUEUE_FRAMES = 10_000
SUBSCRIPTION_QUEUE_FRAMES = 50_000


class _StreamQueue:
    """The frames between the store's dispatch, which must never block,
    and one stream's writer thread. A reader that falls behind is cut:
    the frame that finds the queue full and every frame after it are
    refused, and the writer ends the stream once it has sent what the
    queue holds. What the reader got is then a gap-free prefix of the
    commit order, so a resume from its newest version loses no event
    (and a replay longer than the queue still moves it forward)."""

    __slots__ = ("frames", "cut", "_on_cut")

    def __init__(self, maxsize: int, on_cut: Callable[[], None]):
        self.frames: "queue.Queue[Any]" = queue.Queue(maxsize=maxsize)
        self.cut = False
        self._on_cut = on_cut

    def put(self, frame: Any) -> None:
        if self.cut:
            return
        try:
            self.frames.put_nowait(frame)
        except queue.Full:
            self.cut = True
            self._on_cut()


class Forbidden(Exception):
    pass


def _cached_event_bytes(event: Event, version: int = 2) -> bytes:
    """Pickle one watch event as ``(type, obj, old, commit_ts)``,
    memoized on the event so N binary watchers (and the replay path)
    pay ONE encode — the reference's cachingObject, applied to the
    binary wire. The commit timestamp rides along so the client can
    measure end-to-end watch delivery (freshness SLI); decoders accept
    the legacy 3-tuple too. A watcher pinned to codec v1 (mixed-version
    roll: codec.negotiate) gets the legacy 3-tuple from its own memo
    slot — the wire contract is the negotiated one, not whatever the
    server happens to emit. Benign race: two watch writers may both
    encode the first time; both produce identical bytes and one
    assignment wins."""
    from kubernetes_tpu_torch.apiserver import codec

    if version < 2:
        b = event.__dict__.get("_bin_frame_v1")
        if b is None:
            b = codec.encode((event.type, event.obj, event.old_obj))
            event.__dict__["_bin_frame_v1"] = b
        return b
    b = event.__dict__.get("_bin_frame")
    if b is None:
        # the commit-time origin trace context (fleet tracing) rides
        # INSIDE the ts slot — ``(ts, origin)`` instead of a bare float
        # — so the 4-tuple wire contract is unchanged for untraced
        # events and v2 decoders distinguish the shapes by type
        ts = event.ts
        origin = getattr(event, "origin", None)
        if origin is not None:
            ts = (ts, origin)
        b = codec.encode(
            (event.type, event.obj, event.old_obj, ts))
        event.__dict__["_bin_frame"] = b
    return b




# per-kind selectable fields (reference ToSelectableFields:
# pkg/registry/core/pod/strategy.go, node/strategy.go; every other kind
# supports only the generic metadata pair) — an unlisted field is the
# client's 400 regardless of whether any object exists to filter
_GENERIC_FIELDS = {"metadata.name", "metadata.namespace"}
_SELECTABLE_FIELDS = {
    "Pod": _GENERIC_FIELDS | {
        "spec.nodeName", "spec.restartPolicy", "spec.schedulerName",
        "spec.serviceAccountName", "status.phase", "status.podIP",
        "status.nominatedNodeName",
    },
    "Node": _GENERIC_FIELDS | {"spec.unschedulable"},
    "Event": _GENERIC_FIELDS | {
        "involvedObject.kind", "involvedObject.name", "reason", "type",
    },
}


def _parse_field_selector(kind: str, expr: str) -> List[tuple]:
    """Parse + VALIDATE a field selector ("k=v,k2!=v2") against the
    kind's selectable-field set. Validation is unconditional — upstream
    rejects unsupported selectors even when nothing would be filtered."""
    allowed = _SELECTABLE_FIELDS.get(kind, _GENERIC_FIELDS)
    checks: List[tuple] = []
    for part in expr.split(","):
        part = part.strip()
        if not part:
            continue
        if "!=" in part:
            key, _, val = part.partition("!=")
            want_eq = False
        elif "==" in part:
            key, _, val = part.partition("==")
            want_eq = True
        elif "=" in part:
            key, _, val = part.partition("=")
            want_eq = True
        else:
            raise ValueError(f"invalid field selector clause {part!r}")
        key = key.strip()
        if key not in allowed:
            raise ValueError(f"field label not supported: {key!r}")
        checks.append((key, val.strip(), want_eq))
    return checks


def _field_checks_match(obj, checks: List[tuple]) -> bool:
    import re

    def resolve(path: str) -> str:
        cur = obj
        for seg in path.split("."):
            # collapse acronym runs: podIP -> pod_ip, not pod_i_p
            snake = re.sub(r"(?<=[a-z0-9])(?=[A-Z])", "_", seg).lower()
            cur = getattr(cur, snake, "")
        if cur is None:
            return ""
        if isinstance(cur, bool):
            return "true" if cur else "false"   # wire casing
        return str(cur)

    return all((resolve(key) == val) == want_eq
               for key, val, want_eq in checks)


def json_merge_patch(target: Any, patch: Any) -> Any:
    """RFC 7386 JSON Merge Patch: nulls delete keys, objects merge
    recursively, everything else replaces."""
    if not isinstance(patch, dict):
        return patch
    out = dict(target) if isinstance(target, dict) else {}
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        elif isinstance(v, dict):
            out[k] = json_merge_patch(out.get(k), v)
        else:
            out[k] = v
    return out


Authorizer = Callable[[str, str, str, str], bool]  # (user, verb, kind, ns)


def allow_all(user: str, verb: str, kind: str, namespace: str) -> bool:
    return True


class _DevNullWriter:
    """Stands in for wfile after a fault aborted the connection, so the
    base handler's post-request flush/close never touches the dead
    socket (which would traceback on every injected reset)."""

    closed = False

    def write(self, data) -> int:
        return len(data)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class _TruncatingWriter:
    """Passes through the first ``limit`` bytes, then RSTs the
    connection and swallows the rest — the 'response cut mid-body'
    failure mode (a proxy died, a socket buffer was torn down)."""

    closed = False

    def __init__(self, handler: "_Handler", inner, limit: int):
        self._handler = handler
        self._inner = inner
        self._remaining = max(0, int(limit))
        self._aborted = False

    def write(self, data) -> int:
        if self._aborted:
            return len(data)
        take = data[:self._remaining]
        if take:
            try:
                self._inner.write(take)
            except OSError:
                self._aborted = True
                return len(data)
            self._remaining -= len(take)
        if self._remaining <= 0:
            try:
                self._inner.flush()
            except OSError:
                pass
            self._aborted = True
            self._handler._abort_socket()
        return len(data)

    def flush(self) -> None:
        if not self._aborted:
            try:
                self._inner.flush()
            except OSError:
                pass

    def close(self) -> None:
        pass

    def finish_request(self) -> None:
        """The faulted request is over: a truncation fault always ends
        the connection — even when the response fit under the byte
        limit — so the writer never leaks into the next keep-alive
        request with leftover budget."""
        if not self._aborted:
            try:
                self._inner.flush()
            except OSError:
                pass
            self._aborted = True
            self._handler._abort_socket()


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # a request/response ping-pong on a keep-alive connection stalls
    # ~40ms per round trip under Nagle + delayed ACK; the reference
    # apiserver's HTTP/2 stack never batches this way either
    disable_nagle_algorithm = True
    server: "APIServer"

    # -- plumbing ------------------------------------------------------
    def log_message(self, fmt, *args):  # quiet
        pass

    # -- admin-route registry: the debug control surfaces, declared once
    # so every cross-cutting policy (FaultGate exemption, lane-slot
    # exemption, verb dispatch) derives from the same table instead of
    # hand-rolled path checks per verb handler. All admin routes share
    # the control-plane trust envelope and must stay reachable while the
    # server is sick — chaos must not lock out its own controls, and a
    # full lane must not block the postmortem dump.
    ADMIN_ROUTES = {
        "/debug/faults": "_serve_faults_admin",
        "/debug/partition": "_serve_partition_admin",
        "/debug/trace": "_serve_trace_admin",
        "/debug/apf": "_serve_apf_admin",
        "/debug/slo": "_serve_slo_admin",
    }

    # -- flow-control exemption envelope: paths that must NEVER be
    # queued, rejected, or charged seats — by either admission path.
    # Flow control must never fail a liveness probe (429 under load
    # would get the server restarted exactly when it's busy), never
    # blind the metrics scraper, and (via ADMIN_ROUTES) never lock out
    # the debug surfaces mid-overload.
    _EXEMPT_PATHS = ("/healthz", "/livez", "/readyz",
                     "/metrics", "/api/v1/partitiontopology",
                     "/api/v1/subscription")

    def _admission_exempt(self, path: str) -> bool:
        return path in self.ADMIN_ROUTES or path in self._EXEMPT_PATHS

    # -- legacy max-in-flight gate (reference apiserver filters/
    # maxinflight.go: separate readonly and mutating lanes; a full lane
    # answers 429 with a COMPUTED Retry-After so one hot client cannot
    # starve the control plane). Active only when the server was built
    # with ``flow_control=None``; the APF path below replaces it
    # otherwise. Long-running requests (watches) are exempt, as
    # upstream's longRunningRequestCheck exempts them.
    def _gate(self) -> Optional[Tuple[threading.Semaphore, LaneStats]]:
        path = self.path.split("?", 1)[0]
        if self._admission_exempt(path):
            # admin surfaces never consume a lane slot: /debug/trace is
            # exactly for when the server is overloaded, and /debug/
            # faults must stay operable mid-chaos
            return None
        if self.command in ("GET", "HEAD"):
            if "watch=" in self.path:
                return None      # long-running: never counts against a lane
            if self.server.readonly_lane is None:
                return None
            return self.server.readonly_lane, self.server.lane_stats["ro"]
        if self.server.mutating_lane is None:
            return None
        return self.server.mutating_lane, self.server.lane_stats["rw"]

    # -- fault injection (faults.py FaultGate; the chaos-over-REST
    # middleware). Runs BEFORE the in-flight lanes so an injected reset
    # never consumes a lane slot; the exemption envelope is the SAME
    # set admission honors (plus ADMIN_ROUTES, checked at the call
    # sites) — a probe path added to one layer's exemption and not the
    # other would silently let chaos 429 a liveness probe that
    # admission promised never to fail.
    _FAULT_EXEMPT = _EXEMPT_PATHS

    _sock_aborted = False   # instance flag set by _abort_socket
    _apf_ticket = None      # live APF ticket while a request executes

    def _abort_socket(self) -> None:
        """RST the client (SO_LINGER 1,0 → no FIN, no more bytes) and
        neuter wfile so the base class's final flush is a no-op."""
        self._sock_aborted = True
        self.close_connection = True
        try:
            self.connection.setsockopt(
                socket.SOL_SOCKET, socket.SO_LINGER,
                struct.pack("ii", 1, 0))
        except OSError:
            pass
        try:
            self.connection.close()
        except OSError:
            pass
        self.wfile = _DevNullWriter()

    def _inject_fault(self) -> bool:
        """Consult the FaultGate for this request. True = the request
        was fully consumed by the fault (aborted or answered); False =
        continue normal handling (possibly slowed or truncated)."""
        gate = self.server.fault_gate
        if not gate._rules:
            return False
        path = self.path.split("?", 1)[0]
        if path in self._FAULT_EXEMPT or path in self.ADMIN_ROUTES:
            return False
        rule = gate.decide(self.command, resource_of(self.path))
        if rule is None:
            return False
        if rule.fault == "latency":
            time.sleep(rule.latency)
            return False
        if rule.fault == "truncate":
            self.wfile = _TruncatingWriter(self, self.wfile,
                                           rule.truncate_bytes)
            return False
        if rule.fault == "reset":
            self._abort_socket()
            return True
        # "error": overload pushback burst — drain the body first so
        # keep-alive framing stays intact for the client's retry
        length = int(self.headers.get("Content-Length") or 0)
        if length:
            self.rfile.read(length)
        body = json.dumps({
            "kind": "Status", "status": "Failure",
            "reason": "TooManyRequests" if rule.code == 429
            else "ServiceUnavailable",
            "message": "injected fault: overload pushback",
            "code": rule.code,
        }).encode()
        self.send_response(rule.code)
        self.send_header("Retry-After", str(rule.retry_after))
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        return True

    def _handle_write(self, inner) -> None:
        """A mutating request: its write ticket, if the topology gate
        gave it one, closes once it has answered."""
        self._write_ticket = None
        try:
            self._handle_gated(inner)
        finally:
            if self._write_ticket is not None:
                self.server.close_write(self._write_ticket)
                self._write_ticket = None

    def _open_write(self) -> None:
        # under ``write_gate``; one ticket a request
        if getattr(self, "_write_ticket", None) is None:
            self._write_ticket = self.server.open_write()

    def _handle_gated(self, inner) -> None:
        self._body_consumed = False   # per-request: see _send_429 drain
        # pin the wire version FIRST: every response (including the
        # fault-injected and 429 paths below) carries the echoed stamp,
        # so a mid-roll client always learns what contract it got
        from kubernetes_tpu_torch.apiserver import codec

        try:
            self._codec_version = codec.negotiate(
                self.headers.get(codec.VERSION_HEADER))
        except ValueError as e:
            # unsatisfiable stamp: explicit refusal, never a silent
            # decode skew. Drop keep-alive — the body framing of a
            # client this confused is not worth trusting.
            self.close_connection = True
            self._send_error(400, "UnsupportedCodecVersion", str(e))
            return
        if self._inject_fault():
            return
        from kubernetes_tpu_torch.observability.tracer import (
            TRACE_HEADER, parse_trace_header, set_request_context)

        ctx = parse_trace_header(self.headers.get(TRACE_HEADER))
        if ctx is not None:
            self.server.trace_headers_seen += 1
        tracer = self.server.tracer
        span = None
        if tracer is not None and tracer.enabled \
                and "watch=" not in self.path:
            # watches are long-running: a span per watch would never
            # close while the stream lives (upstream's longRunning
            # exemption, applied to tracing too). A propagated context
            # carries the CLIENT's sampling decision and it wins both
            # ways: sampled=1 always opens the server-side child span
            # (bypassing the 1-in-N fallback — the sampled pod's trace
            # must stitch across every hop), sampled=0 never does.
            # Context-free requests keep the 1-in-N fallback — an
            # unsampled span per request would wrap the ring in seconds
            # at bench request rates and evict the sampled pod traces
            # the recorder exists to keep.
            if ctx is not None:
                if ctx.sampled:
                    # the wire parent span id is a DIFFERENT process's
                    # counter (span ids are per-process and collide
                    # across the fleet), so it rides as an attribute
                    # and the server span is a local root; the merged
                    # timeline stitches hops by trace id + ctx_parent.
                    span = tracer.span(
                        f"rest.{self.command}", trace=ctx.trace,
                        path=self.path.split("?", 1)[0],
                        ctx_parent=ctx.parent)
            else:
                rate = tracer.sample_rate
                if rate >= 1.0 or (rate > 0.0 and
                                   next(self.server._req_seq)
                                   % max(1, round(1.0 / rate)) == 0):
                    span = tracer.span(f"rest.{self.command}",
                                       path=self.path.split("?", 1)[0])
        set_request_context(ctx)
        try:
            if span is not None:
                with span:
                    self._dispatch_gated(inner)
            else:
                self._dispatch_gated(inner)
        finally:
            set_request_context(None)
            wfile = self.wfile
            if isinstance(wfile, _TruncatingWriter):
                wfile.finish_request()

    def _content_length(self) -> int:
        """Malformed Content-Length must not traceback the admission
        path (it runs before auth for every request): treat it as 0 AND
        drop keep-alive — the framing of any body the client did send
        is unknowable, so its unread bytes must not corrupt the next
        request on this connection. Every consumer (admission width,
        the 429 drain, ``_read_body``) routes through here, so the
        close decision is made exactly once."""
        try:
            return int(self.headers.get("Content-Length") or 0)
        except ValueError:
            self.close_connection = True
            return 0

    def _send_429(self, message: str, retry_after: float,
                  level: str = "", schema: str = "",
                  epoch: Optional[int] = None) -> None:
        """Overload pushback with an HONEST Retry-After (the level's or
        lane's expected drain time) plus the rejecting priority level /
        flow schema headers the client's retry accounting keys on
        (X-Kubernetes-PF-* response headers). ``epoch`` rides as
        X-Partition-Epoch when the slice moved away: a client with older
        routing refreshes its topology and re-routes."""
        # drain the body first so keep-alive framing stays intact for
        # the client's retry (same discipline as the injected-fault 429)
        # — unless a handler already consumed it
        length = self._content_length()
        if length and not getattr(self, "_body_consumed", False):
            self.rfile.read(length)
        body = json.dumps({
            "kind": "Status", "status": "Failure",
            "reason": "TooManyRequests",
            "message": message,
            "code": 429,
        }).encode()
        self.send_response(429)
        self.send_header("Retry-After", f"{retry_after:g}")
        if level:
            self.send_header("X-Kubernetes-PF-PriorityLevel", level)
        if schema:
            self.send_header("X-Kubernetes-PF-FlowSchema", schema)
        if epoch is not None:
            self.send_header("X-Partition-Epoch", str(int(epoch)))
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _run_inner(self, inner) -> None:
        try:
            inner()
        except Forbidden as e:
            # raised before any bytes were written (body reads precede
            # every send): e.g. a binary body from an unauthenticated
            # client
            self._send_error(403, "Forbidden", str(e))

    def _dispatch_gated(self, inner) -> None:
        fc = self.server.flowcontrol
        if fc is not None:
            self._dispatch_apf(fc, inner)
            return
        gated = self._gate()
        if gated is None:
            self._run_inner(inner)
            return
        lane, stats = gated
        if not lane.acquire(blocking=False):
            self._send_429(
                "too many requests in flight, try again later",
                stats.retry_after())
            return
        stats.start()
        t0 = time.monotonic()
        try:
            self._run_inner(inner)
        finally:
            lane.release()
            stats.done(time.monotonic() - t0)

    # -- API Priority & Fairness admission (flowcontrol.py; reference
    # filters/priority-and-fairness.go): the default admission path.
    # FlowSchemas route identity/verb/resource to a priority level;
    # the level's shuffle-sharded queueset fairly queues or rejects.
    def _dispatch_apf(self, fc: FlowController, inner) -> None:
        path = self.path.split("?", 1)[0]
        if self._admission_exempt(path):
            self._run_inner(inner)
            return
        user = self._user()
        groups_fn = getattr(self.server.authorizer, "groups_for", None)
        groups = groups_fn(user) if groups_fn is not None else ()
        is_watch = self.command in ("GET", "HEAD") \
            and "watch=" in self.path
        try:
            items_hint = int(
                self.headers.get("X-Kubernetes-Request-Items") or 0)
        except ValueError:
            items_hint = 0
        # the flow distinguisher is SERVER-derived (identity/namespace,
        # as upstream insists): X-Flow-Id may refine it only from the
        # control-plane trust envelope (_binary_decode_allowed — system
        # identities or the loopback escape hatch). An untrusted tenant
        # minting a fresh distinguisher per request would become a new
        # flow per request, hash across every queue in its level, and
        # shred the shuffle-shard isolation this subsystem exists for.
        flow_id = self.headers.get("X-Flow-Id") or ""
        if flow_id and not self._binary_decode_allowed():
            flow_id = ""
        try:
            ticket = fc.admit(
                user=user, groups=groups or (), verb=self.command,
                resource=resource_of(self.path),
                namespace=namespace_of(self.path),
                flow_id=flow_id,
                items_hint=items_hint,
                content_length=self._content_length(),
                is_watch=is_watch, path=self.path)
        except Rejected as rej:
            self._send_429(
                f"too many requests for priority level {rej.level!r} "
                f"({rej.reason}), try again later",
                rej.retry_after, level=rej.level, schema=rej.schema)
            return
        # watches release their watch-init seats right after the stream
        # attaches (_serve_watch); everything else releases here
        self._apf_ticket = ticket
        try:
            self._run_inner(inner)
        finally:
            self._apf_ticket = None
            ticket.release()

    def _send_json(self, code: int, payload: Any,
                   headers: Optional[Dict[str, str]] = None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for key, value in (headers or {}).items():
            self.send_header(key, value)
        self._send_codec_header()
        self.end_headers()
        self.wfile.write(body)

    def _send_codec_header(self) -> None:
        """Echo the pinned wire version (codec.negotiate) on every
        response so the client records/renegotiates across restart
        seams; call between send_response and end_headers."""
        from kubernetes_tpu_torch.apiserver import codec

        self.send_header(
            codec.VERSION_HEADER,
            str(getattr(self, "_codec_version", codec.CODEC_VERSION)))

    def _send_error(self, code: int, reason: str, message: str,
                    headers: Optional[Dict[str, str]] = None) -> None:
        # reference metav1.Status error envelope
        self._send_json(
            code,
            {
                "kind": "Status",
                "status": "Failure",
                "reason": reason,
                "message": message,
                "code": code,
            },
            headers,
        )

    # -- binary codec negotiation (codec.py: the protobuf analog) ------
    def _accepts_binary(self) -> bool:
        from kubernetes_tpu_torch.apiserver import codec

        return codec.BINARY_CONTENT_TYPE in (self.headers.get("Accept") or "")

    # identities allowed to speak the binary codec: the control plane
    # itself (codec.py's trust envelope — "kubelet/scheduler/
    # controller-manager speak it, kubectl speaks JSON"); a mere
    # authenticated namespace SA token must NOT reach the unpickler
    _BINARY_PREFIXES = ("system:kube-", "system:node:")

    def _binary_decode_allowed(self) -> bool:
        """Pickle bodies only from CONTROL-PLANE identities — codec.py's
        trust model. The no-authn escape hatch requires a LOOPBACK
        peer: a tokenless server bound to a reachable interface must
        not be an arbitrary-code-execution endpoint."""
        if not self.server.tokens and self.server.authorizer is allow_all:
            peer = self.client_address[0] if self.client_address else ""
            return peer in ("127.0.0.1", "::1", "::ffff:127.0.0.1")
        user = self._user()
        if user.startswith(self._BINARY_PREFIXES):
            return True
        groups = getattr(self.server.authorizer, "groups_for", None)
        return groups is not None and "system:masters" in groups(user)

    def _read_body(self) -> Any:
        length = self._content_length()
        raw = self.rfile.read(length) if length else b"{}"
        self._body_consumed = True
        ctype = self.headers.get("Content-Type") or ""
        from kubernetes_tpu_torch.apiserver import codec

        if ctype.startswith(codec.BINARY_CONTENT_TYPE):
            if not self._binary_decode_allowed():
                raise Forbidden(
                    "binary bodies require an authenticated client")
            return codec.decode(raw)
        return json.loads(raw or b"{}")

    def _send_bytes(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self._send_codec_header()
        self.end_headers()
        self.wfile.write(body)

    def _send_negotiated(self, code: int, payload: Any,
                         json_fallback: Optional[Callable[[], Any]] = None
                         ) -> None:
        """Send ``payload`` pickled when the client asked for binary;
        otherwise the JSON shape (``json_fallback()`` when the JSON wire
        differs from the binary payload, e.g. objects vs dicts)."""
        from kubernetes_tpu_torch.apiserver import codec

        if self._accepts_binary():
            self._send_bytes(code, codec.encode(payload),
                             codec.BINARY_CONTENT_TYPE)
        else:
            self._send_json(
                code, json_fallback() if json_fallback else payload)

    # -- versioned codec (scheme hub-and-spoke) ------------------------
    def _decode(self, body: Dict, kind: str) -> Any:
        from kubernetes_tpu_torch.api.scheme import SCHEME_V

        api_version = getattr(self, "_api_version", "v1")
        return SCHEME_V.decode(body, kind, api_version)

    def _encode(self, obj: Any) -> Dict:
        from kubernetes_tpu_torch.api.scheme import SCHEME_V

        api_version = getattr(self, "_api_version", "v1")
        return SCHEME_V.encode(obj, api_version)

    # -- authn/authz ---------------------------------------------------
    def _user(self) -> str:
        auth = self.headers.get("Authorization") or ""
        if auth.startswith("Bearer "):
            token = auth[len("Bearer "):].strip()
            user = self.server.tokens.get(token)
            if user is not None:
                return user
            # an unknown token authenticates as no one the policy names
            return f"token:{token[:8]}"
        return "system:anonymous"

    def _check_authz(self, verb: str, kind: str, namespace: str) -> str:
        user = self._user()
        if not self.server.authorize_cached(user, verb, kind, namespace):
            raise Forbidden(f"user {user!r} cannot {verb} {kind}")
        return user

    # -- discovery (the client-go RESTMapper's server half:
    # staging/src/k8s.io/apiserver/pkg/endpoints/discovery) -----------
    @staticmethod
    def _is_discovery_path(path: str) -> bool:
        parts = [p for p in path.split("/") if p]
        return (
            (len(parts) == 2 and parts[0] == "api" and parts[1] == "v1")
            or (len(parts) == 3 and parts[0] == "apis")
        )

    def _serve_discovery(self, path: str) -> None:
        """Discovery of the ``v1`` kinds: every built-in kind is served
        at the internal version only, so no API group is listed and a
        group-version path is a 404."""
        from kubernetes_tpu_torch.api.serialization import CLUSTER_SCOPED

        parts = [p for p in path.split("/") if p]
        if path == "/api":
            self._send_json(200, {"kind": "APIVersions",
                                  "versions": ["v1"]})
            return
        if path == "/apis":
            self._send_json(200, {"kind": "APIGroupList", "groups": []})
            return
        if parts[0] == "api":                       # /api/v1
            resources = [
                {"name": plural, "kind": kind,
                 "namespaced": kind not in CLUSTER_SCOPED}
                for plural, kind in sorted(PLURALS.items())
            ]
            self._send_json(200, {
                "kind": "APIResourceList", "groupVersion": "v1",
                "resources": resources,
            })
            return
        gv = f"{parts[1]}/{parts[2]}"
        self._send_error(404, "NotFound", f"no group/version {gv!r}")

    # -- routing -------------------------------------------------------
    def _route(self) -> Tuple[Optional[str], Optional[str], Optional[str], Optional[str], Dict]:
        """→ (kind, namespace, name, subresource, query). Also resolves
        the request's apiVersion into ``self._api_version``: the legacy
        core path ``/api/v1`` serves the internal hub shape; group
        routes ``/apis/<group>/<version>`` serve versioned spokes
        through the scheme's conversion/defaulting (reference
        InstallLegacyAPI vs InstallAPIs, ``pkg/controlplane/
        instance.go:547,580``)."""
        from kubernetes_tpu_torch.api.scheme import SCHEME_V

        u = urlparse(self.path)
        q = {k: v[0] for k, v in parse_qs(u.query).items()}
        parts = [p for p in u.path.split("/") if p]
        self._api_version = "v1"
        if len(parts) >= 3 and parts[0] == "apis":
            api_version = f"{parts[1]}/{parts[2]}"
            rest = parts[3:]
            ns: Optional[str] = None
            if rest and rest[0] == "namespaces" and len(rest) >= 2:
                ns = rest[1]
                rest = rest[2:]
            if not rest:
                return None, ns, None, None, q
            kind = PLURALS.get(rest[0])
            if kind is None or not SCHEME_V.recognizes(api_version, kind):
                return None, None, None, None, q
            self._api_version = api_version
            name = rest[1] if len(rest) >= 2 else None
            sub = rest[2] if len(rest) >= 3 else None
            return kind, ns, name, sub, q
        # legacy core: /api/v1/...
        if len(parts) < 2 or parts[0] != "api" or parts[1] != "v1":
            return None, None, None, None, q
        rest = parts[2:]
        ns: Optional[str] = None
        if rest and rest[0] == "namespaces" and len(rest) >= 2:
            ns = rest[1]
            rest = rest[2:]
        if not rest:
            return None, ns, None, None, q
        kind = PLURALS.get(rest[0])
        name = rest[1] if len(rest) >= 2 else None
        sub = rest[2] if len(rest) >= 3 else None
        return kind, ns, name, sub, q

    # -- verbs ---------------------------------------------------------
    def do_GET(self) -> None:
        self._handle_gated(self._do_GET)

    def _dispatch_admin(self, verb: str) -> bool:
        """Route an admin path through the ADMIN_ROUTES registry.
        True = the request was an admin request and has been answered."""
        handler = self.ADMIN_ROUTES.get(urlparse(self.path).path)
        if handler is None:
            return False
        getattr(self, handler)(verb)
        return True

    def _serve_trace_admin(self, verb: str) -> None:
        """/debug/trace: the flight recorder's control surface. GET →
        Chrome/Perfetto trace_event JSON of the trailing retention
        window (``?window=SECONDS`` overrides it); DELETE → clear the
        ring. Same control-plane trust envelope as /debug/faults, and
        like it exempt from FaultGate and the in-flight lanes (via
        ADMIN_ROUTES) — the dump must be reachable exactly when the
        server is sick."""
        if not self._binary_decode_allowed():
            self._send_error(403, "Forbidden",
                             "trace admin requires a control-plane identity")
            return
        tracer = self.server.tracer
        if tracer is None or not tracer.enabled:
            # KTPU_TRACE=off yields a disabled (never None) tracer: an
            # explicit 404 beats a 200 empty dump an operator can't
            # tell apart from "nothing happened in the last 60s"
            self._send_error(404, "NotFound", "tracing is not enabled")
            return
        if verb == "GET":
            q = {k: v[0] for k, v in
                 parse_qs(urlparse(self.path).query).items()}
            window = None
            if q.get("window"):
                try:
                    window = float(q["window"])
                except ValueError:
                    self._send_error(400, "BadRequest",
                                     f"invalid window {q['window']!r}")
                    return
            doc = tracer.export_perfetto(window)
            # half-RTT clock-offset echo (TraceFederation): the scraper
            # sends its monotonic send-time as ?echo_mono=; we echo it
            # beside OUR monotonic clock at export so the scraper can
            # place this process's spans on its own timeline with a
            # bounded-skew correction (bound = rtt/2).
            if q.get("echo_mono"):
                try:
                    doc["otherData"]["echo_mono"] = float(q["echo_mono"])
                except ValueError:
                    pass
            doc["otherData"]["server_mono"] = time.monotonic()
            self._send_json(200, doc)
            return
        if verb == "DELETE":
            tracer.clear()
            self._send_json(200, {"kind": "Status", "status": "Success"})
            return
        self._send_error(405, "MethodNotAllowed",
                         "/debug/trace supports GET and DELETE")

    def _serve_apf_admin(self, verb: str) -> None:
        """/debug/apf: API Priority & Fairness introspection. GET → the
        FlowController snapshot (per-level seats/queues/rejections/
        flows, schema match counts, shed state). Same control-plane
        trust envelope as the other debug surfaces, and — via
        ADMIN_ROUTES — exempt from admission itself: the overload
        postmortem must be readable mid-overload."""
        if not self._binary_decode_allowed():
            self._send_error(403, "Forbidden",
                             "apf admin requires a control-plane identity")
            return
        fc = self.server.flowcontrol
        if fc is None:
            self._send_error(404, "NotFound",
                             "flow control is not enabled (legacy "
                             "max-in-flight lanes are active)")
            return
        if verb != "GET":
            self._send_error(405, "MethodNotAllowed",
                             "/debug/apf supports GET")
            return
        self._send_json(200, fc.snapshot())

    def _serve_slo_admin(self, verb: str) -> None:
        """/debug/slo: live SLO evaluation (observability/slo.py). GET
        → every declared SLO's windowed SLI, burn rates, and verdicts
        for THIS process. Same control-plane trust envelope as the
        other debug surfaces and — via ADMIN_ROUTES — exempt from
        admission: the burn-rate postmortem must be readable exactly
        when the fabric is violating its objectives."""
        if not self._binary_decode_allowed():
            self._send_error(403, "Forbidden",
                             "slo admin requires a control-plane identity")
            return
        if verb != "GET":
            self._send_error(405, "MethodNotAllowed",
                             "/debug/slo supports GET")
            return
        from kubernetes_tpu_torch.observability.slo import get_slo_engine

        engine = get_slo_engine()
        if not engine.enabled:
            self._send_error(404, "NotFound",
                             "SLO evaluation is not enabled (KTPU_SLO=off)")
            return
        self._send_json(200, engine.evaluate())

    def _serve_faults_admin(self, verb: str) -> None:
        """/debug/faults: runtime fault-injection control surface.
        GET → config + injection counters; POST/PUT → replace rule set
        (``{"seed": S, "rules": [...]}``); DELETE → clear. Guarded by
        the binary codec's control-plane trust envelope: loopback on a
        tokenless server, control-plane identity otherwise — an
        ordinary namespace token must not be able to break the wire."""
        if not self._binary_decode_allowed():
            self._send_error(403, "Forbidden",
                             "fault admin requires a control-plane identity")
            return
        gate = self.server.fault_gate
        if verb == "GET":
            self._send_json(200, gate.snapshot())
            return
        if verb == "DELETE":
            gate.clear()
            self._send_json(200, {"kind": "Status", "status": "Success"})
            return
        if verb not in ("POST", "PUT"):
            self._send_error(405, "MethodNotAllowed",
                             "/debug/faults supports GET, POST, PUT, "
                             "and DELETE")
            return
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(length) if length else b"{}"
        try:
            gate.configure(json.loads(raw or b"{}"))
        except (ValueError, TypeError) as e:
            self._send_error(400, "BadRequest", f"invalid fault spec: {e}")
            return
        self._send_json(200, gate.snapshot())






    # -- elastic control plane: the freeze/ownership write gate --------
    def _reshard_verdict(self, kind: str, ns: Optional[str],
                         name: Optional[str]) -> Optional[tuple]:
        """Judge one mutation against the live partition topology.
        None = allowed (and counted on the slot-write ledger the
        rebalancer reads); ("frozen", retry_after) = the slice is
        inside a migration's freeze window; ("stale", epoch) = this
        server no longer owns the slice — the caller's routing table
        predates epoch."""
        server = self.server
        topo = server.partition_topology
        if topo is None:
            return None
        slot = topo.slot_of(kind, ns, name)
        if slot is None:
            return None
        frozen = server.frozen_slots.get(slot)
        if frozen is not None:
            deadline, _eta = frozen
            remaining = deadline - time.monotonic()
            if remaining > 0:
                return ("frozen", max(0.05, remaining))
            server.frozen_slots.pop(slot, None)   # auto-thaw backstop
        if topo.owner[slot] != server.partition_index:
            return ("stale", topo.epoch)
        server.slot_writes[slot] = server.slot_writes.get(slot, 0) + 1
        if kind == "Pod" and ns:
            server.ns_writes[ns] = server.ns_writes.get(ns, 0) + 1
        return None

    def _reshard_gate(self, kind: Optional[str], ns: Optional[str],
                      name: Optional[str]) -> bool:
        """Answer a topology-shaped 429 for a gated mutation. True =
        the request was answered (frozen slice: computed Retry-After so
        the client's existing pushback loop simply pauses through the
        freeze window; moved slice: the new epoch so the client
        refreshes its routing and re-sends to the owner)."""
        if kind is None or self.server.partition_topology is None:
            return False
        with self.server.write_gate:
            verdict = self._reshard_verdict(kind, ns, name)
            if verdict is None:
                self._open_write()
                return False
        if verdict[0] == "frozen":
            # NO epoch header: frozen means the caller's routing is
            # CORRECT and the only cure is waiting out the advertised
            # window — the epoch header is the re-route signal and
            # would send clients re-splitting a batch that maps to
            # exactly the same frozen slice
            self._send_429(
                f"{kind} {ns or ''}/{name or ''}: keyspace slice frozen "
                f"by a live partition migration",
                verdict[1], level="reshard")
        else:
            self._send_429(
                f"{kind} {ns or ''}/{name or ''}: slice moved — this "
                f"server no longer owns it (topology epoch "
                f"{verdict[1]})",
                0.05, level="reshard", epoch=verdict[1])
        return True

    def _reshard_gate_bulk(self, kind: str, keys) -> bool:
        """Gate a bulk verb: every (ns, name) must be owned and thawed
        BEFORE any item mutates state — a half-applied bulk request
        under a topology flip would be exactly the torn write the
        freeze protocol exists to prevent. Worst verdict wins (stale
        beats frozen: re-routing supersedes waiting)."""
        if self.server.partition_topology is None:
            return False
        worst: Optional[tuple] = None
        with self.server.write_gate:
            for ns, name in keys:
                verdict = self._reshard_verdict(kind, ns, name)
                if verdict is None:
                    continue
                if verdict[0] == "stale":
                    worst = verdict
                    break
                worst = worst or verdict
            if worst is None:
                self._open_write()
                return False
        if worst[0] == "frozen":
            # no epoch header — see _reshard_gate: frozen = wait, the
            # routing is already right
            self._send_429(
                f"bulk {kind} batch touches a keyspace slice frozen by "
                f"a live partition migration", worst[1], level="reshard")
        else:
            self._send_429(
                f"bulk {kind} batch touches a moved slice (topology "
                f"epoch {worst[1]})", 0.05, level="reshard",
                epoch=worst[1])
        return True

    def _serve_partition_admin(self, verb: str) -> None:
        """/debug/partition: the live-resharding control surface the
        ReshardCoordinator drives — freeze/unfreeze keyspace slices,
        read a slice out, adopt/evict objects (the silent placement
        channel), install a new topology, and inspect the slot-write
        ledger. Control-plane trust envelope; exempt from flow control
        and the FaultGate like every admin route (a migration must stay
        drivable while the fabric is sick — that is its point)."""
        if not self._binary_decode_allowed():
            self._send_error(403, "Forbidden",
                             "partition admin requires a control-plane "
                             "identity")
            return
        server = self.server
        if verb == "GET":
            topo = server.partition_topology
            store = server.store
            with store._lock:
                objects = sum(
                    len(getattr(store, attr))
                    for attr, _ in store._KIND_TABLES.values())
                mutations = sum(store._kind_seq.values())
            now = time.monotonic()
            self._send_json(200, {
                "partition": server.partition_index,
                "partitions": server.partition_count,
                "epoch": topo.epoch if topo is not None else 0,
                "topology": topo.to_dict() if topo is not None else None,
                "frozen": sorted(
                    s for s, (dl, _e) in server.frozen_slots.items()
                    if dl > now),
                "slot_writes": {str(k): v
                                for k, v in server.slot_writes.items()},
                "ns_writes": dict(server.ns_writes),
                "objects": objects,
                "mutations": mutations,
            })
            return
        if verb != "POST":
            self._send_error(405, "MethodNotAllowed",
                             "/debug/partition supports GET and POST")
            return
        try:
            body = self._read_body()
        except json.JSONDecodeError as e:
            self._send_error(400, "BadRequest", f"invalid JSON: {e}")
            return
        if not isinstance(body, dict):
            self._send_error(400, "BadRequest", "op body required")
            return
        op = body.get("op")
        try:
            if op == "freeze":
                drained = server.freeze_and_drain(
                    body.get("slots") or (), float(body.get("eta") or 5.0))
                self._send_json(200, {"frozen": sorted(
                    int(s) for s in body.get("slots") or ()),
                    "drained": drained})
            elif op == "unfreeze":
                slots = body.get("slots")
                if slots is None:
                    server.frozen_slots.clear()
                else:
                    for s in slots:
                        server.frozen_slots.pop(int(s), None)
                self._send_json(200, {"frozen": sorted(
                    server.frozen_slots)})
            elif op == "topology":
                from kubernetes_tpu_torch.apiserver.partition import (
                    PartitionTopology,
                )

                doc = body.get("topology") or {}
                installed = server.install_topology(
                    PartitionTopology.from_dict(doc))
                self._send_json(200, {
                    "installed": installed,
                    "epoch": server.partition_topology.epoch
                    if server.partition_topology else 0})
            elif op == "slice":
                slots = {int(s) for s in body.get("slots") or ()}
                spread = frozenset(body.get("spread") or ())
                slot_count = int(body.get("slot_count") or 0)
                out = self._collect_slice(slots, spread, slot_count,
                                          body.get("namespace"))
                self._send_json(200, {
                    "objects": {k: [to_wire(o) for o in objs]
                                for k, objs in out.items()}})
            elif op == "adopt":
                counts = {}
                for kind, items in (body.get("objects") or {}).items():
                    objs = [from_wire(w, kind) for w in items]
                    counts[kind] = server.store.adopt_objects(kind, objs)
                server.invalidate_list_caches()
                self._send_json(200, {"adopted": counts})
            elif op == "evict":
                counts = {}
                for kind, keys in (body.get("keys") or {}).items():
                    got = server.store.evict_objects(
                        kind, [(k[0], k[1]) for k in keys])
                    counts[kind] = len(got)
                server.invalidate_list_caches()
                self._send_json(200, {"evicted": counts})
            elif op == "evict_unowned":
                # post-crash reconciliation: silently drop every
                # sharded object this server does not own under the
                # committed topology (orphan copies from a torn
                # migration — the owner holds the live ones)
                topo = server.partition_topology
                if topo is None:
                    self._send_json(200, {"evicted": {}})
                    return
                counts = {}
                from kubernetes_tpu_torch.apiserver.partition import (
                    SHARDED_CLUSTER_KINDS,
                    SHARDED_NAMESPACED_KINDS,
                )

                for kind in (tuple(SHARDED_NAMESPACED_KINDS)
                             + tuple(SHARDED_CLUSTER_KINDS)):
                    attr, _ = server.store._KIND_TABLES[kind]
                    with server.store._lock:
                        doomed = [
                            (o.metadata.namespace, o.metadata.name)
                            for o in getattr(server.store, attr).values()
                            if topo.partition_of(
                                kind, o.metadata.namespace,
                                o.metadata.name)
                            != server.partition_index]
                    if doomed:
                        got = server.store.evict_objects(kind, doomed)
                        counts[kind] = len(got)
                server.invalidate_list_caches()
                self._send_json(200, {"evicted": counts})
            else:
                self._send_error(400, "BadRequest",
                                 f"unknown partition op {op!r}")
        except (ValueError, TypeError, KeyError) as e:
            self._send_error(400, "BadRequest",
                             f"partition op {op!r} failed: {e}")

    def _collect_slice(self, slots, spread, slot_count,
                       namespace: Optional[str] = None) -> Dict[str, list]:
        """Objects in the given hash slots (both sharded kinds), read
        under the store lock — the copy half of a slice migration. The
        SPREAD set and slot count come from the PROPOSED topology: a
        split must cut the slice exactly where the new routing will.
        ``namespace`` narrows a split's copy to the spreading tenant."""
        from kubernetes_tpu_torch.apiserver.partition import (
            NUM_SLOTS,
            SHARDED_CLUSTER_KINDS,
            SHARDED_NAMESPACED_KINDS,
            slot_for,
        )

        slot_count = slot_count or NUM_SLOTS
        store = self.server.store
        out: Dict[str, list] = {}
        with store._lock:
            for kind in (tuple(SHARDED_NAMESPACED_KINDS)
                         + tuple(SHARDED_CLUSTER_KINDS)):
                if namespace is not None \
                        and kind not in SHARDED_NAMESPACED_KINDS:
                    continue   # a namespace split never moves Nodes
                attr, _ = store._KIND_TABLES[kind]
                got = [
                    o for o in getattr(store, attr).values()
                    if (namespace is None
                        or o.metadata.namespace == namespace)
                    and slot_for(kind, o.metadata.namespace,
                                 o.metadata.name, slot_count,
                                 spread) in slots]
                if got:
                    out[kind] = got
        return out

    def _do_GET(self) -> None:
        u = urlparse(self.path)
        if self._dispatch_admin("GET"):
            return
        if u.path in ("/healthz", "/livez", "/readyz"):
            body = b"ok"
            self.send_response(200)
            self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if u.path == "/metrics":
            text = self.server.metrics_text()
            body = text.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if u.path == "/api/v1/partitiontopology":
            # which partition of the partitioned control plane this
            # server is: a client with misordered URLs fails its check
            # instead of reading half-empty partitions. With a live
            # topology installed the whole routing document rides along
            # (epoch, slot owners, spread namespaces, endpoint URLs), so
            # clients re-route on an epoch change. Exempt like the
            # probes: it must answer mid-overload too
            doc = {
                "partition": self.server.partition_index,
                "partitions": self.server.partition_count,
            }
            topo = self.server.partition_topology
            if topo is not None:
                doc.update(topo.to_dict())
            self._send_json(200, doc)
            return
        if u.path == "/api/v1/subscription":
            # the read tier's commit stream: every event of every kind,
            # resumed by resourceVersion; exempt like the topology doc
            self._serve_subscription(u)
            return
        if u.path in ("/api", "/apis") or self._is_discovery_path(u.path):
            self._serve_discovery(u.path)
            return
        if self.server.fenced.is_set():
            # a read replica past its replication-lag budget: a read
            # served now would break the staleness contract. The 503's
            # header tells the client to read from a sibling or the
            # owner; probes, metrics and the topology doc stay served
            self._send_error(
                503, "ReplicaFenced",
                "read replica fenced: replication lag over budget — "
                "re-route to a sibling or the owner",
                {"X-Replica-Fenced": "1", "Retry-After": "0.5"})
            return
        kind, ns, name, sub, q = self._route()
        if kind is None:
            self._send_error(404, "NotFound", f"no route for {self.path}")
            return
        try:
            self._check_authz("get" if name else "list", kind, ns or "")
        except Forbidden as e:
            self._send_error(403, "Forbidden", str(e))
            return
        store = self.server.store
        # selectors parse BEFORE the list/watch split: both paths honor
        # them, and both reject unsupported fields with 400
        label_sel = None
        field_checks = None
        if q.get("labelSelector"):
            from kubernetes_tpu_torch.api.labels import parse_selector

            try:
                label_sel = parse_selector(q["labelSelector"])
            except Exception as e:  # noqa: BLE001 — grammar error
                self._send_error(400, "BadRequest",
                                 f"invalid labelSelector: {e}")
                return
        if q.get("fieldSelector"):
            try:
                field_checks = _parse_field_selector(
                    kind, q["fieldSelector"])
            except ValueError as e:
                self._send_error(400, "BadRequest", str(e))
                return
        if q.get("watch") in ("true", "1"):
            try:
                rv = int(q.get("resourceVersion") or 0)
            except ValueError:
                self._send_error(
                    400, "BadRequest",
                    f"invalid resourceVersion {q.get('resourceVersion')!r}",
                )
                return
            self._serve_watch(kind, ns, rv, label_sel, field_checks)
            return
        if name is not None:
            obj = store.get_object(kind, ns or "default", name)
            if obj is None:
                self._send_error(404, "NotFound", f"{kind} {name!r} not found")
                return
            self._send_negotiated(200, obj,
                                  json_fallback=lambda: self._encode(obj))
            return
        # list + RV atomically: a watch from this RV misses nothing.
        # Selector-free binary lists serve from the per-kind pre-encoded
        # cache — the hot reflector path pays no per-request encode.
        # Leases are excluded: renewals mutate lease state without a
        # dispatch, so kind_seq cannot validate a cached body for them.
        if label_sel is None and field_checks is None \
                and kind != "Lease" and self._accepts_binary():
            from kubernetes_tpu_torch.apiserver import codec

            self._send_bytes(200, self.server.cached_list_binary(kind, ns),
                             codec.BINARY_CONTENT_TYPE)
            return
        objs, rv = store.list_objects_with_rv(kind, ns)
        fc = self.server.flowcontrol
        if fc is not None:
            # feed width estimation: the NEXT list of this resource
            # charges seats proportional to what this one served
            fc.width.note_list_size(resource_of(self.path), len(objs))
        if label_sel is not None:
            objs = [o for o in objs
                    if label_sel.matches(o.metadata.labels)]
        if field_checks is not None:
            objs = [o for o in objs
                    if _field_checks_match(o, field_checks)]
        self._send_negotiated(
            200,
            {"kind": f"{kind}List", "resourceVersion": rv, "items": objs},
            json_fallback=lambda: {
                "kind": f"{kind}List",
                "apiVersion": getattr(self, "_api_version", "v1"),
                "metadata": {"resourceVersion": str(rv)},
                "items": [self._encode(o) for o in objs],
            },
        )

    def _bulk_bindings(self, ns: Optional[str]) -> None:
        """POST .../bindings with a BindingList: the batch-native wire
        for the TPU commit path — one request, one store lock, one
        batched watch delivery for N bindings (store.bind_many). Each
        item is still its own transaction with the exact per-pod
        semantics of POST pods/{name}/binding (reference
        storage.go:159 BindingREST.Create); failures come back
        positionally. The reference has no bulk verb — its Go scheduler
        amortizes with 64 goroutines instead; a batch scheduler that
        solves 4096 placements per device call would serialize on
        per-pod round trips."""
        try:
            body = self._read_body()
        except json.JSONDecodeError as e:
            self._send_error(400, "BadRequest", f"invalid JSON: {e}")
            return
        items = body.get("items") if isinstance(body, dict) else None
        if not isinstance(items, list):
            self._send_error(400, "BadRequest",
                             "BindingList body with items required")
            return
        bindings: List[Tuple[str, str, str, str]] = []
        try:
            for it in items:
                if isinstance(it, (tuple, list)):
                    bns, name, uid, node = it
                else:
                    bns = it.get("namespace") or ns or "default"
                    name = it.get("name") or ""
                    uid = it.get("uid") or ""
                    node = (it.get("target") or {}).get("name") \
                        or it.get("nodeName", "")
                bindings.append((bns, name, uid, node))
        except (ValueError, TypeError, AttributeError) as e:
            self._send_error(400, "BadRequest", f"malformed binding: {e}")
            return
        try:
            for bns in {b[0] for b in bindings}:
                self._check_authz("create", "Binding", bns)
        except Forbidden as e:
            self._send_error(403, "Forbidden", str(e))
            return
        if self._reshard_gate_bulk("Pod",
                                   [(b[0], b[1]) for b in bindings]):
            return
        errors = self.server.store.bind_many(bindings)
        failures = [
            {"index": i,
             "code": 404 if isinstance(err, KeyError) else 409,
             "message": str(err)}
            for i, err in enumerate(errors) if err is not None
        ]
        self._send_negotiated(201, {
            "kind": "Status",
            "status": "Success" if not failures else "Failure",
            "bound": len(bindings) - len(failures),
            "failures": failures,
        })

    def _apply_pod_status(self, ns: str, name: str, status: dict,
                          user: str) -> Optional[tuple]:
        """Apply one pods/status payload — the EXACT single-PUT
        semantics (validating admission against the proposed object,
        then phase/podIP/hostIP, nominatedNodeName, conditions in that
        order), shared by the per-object subresource handler and the
        bulk ``/statuses`` verb so both produce identical store mutation
        sequences. Returns None on success, (code, reason, message) on
        failure."""
        store = self.server.store
        # status writes dispatch through validating admission too
        # (NodeRestriction: a kubelet may only write status of pods
        # bound to it). Validators must judge the PROPOSED object —
        # req.obj carries the incoming status applied to a copy of
        # the live pod, old_obj the untouched stored one.
        live = store.get_pod(ns, name)
        if live is not None:
            from kubernetes_tpu_torch.api.types import shallow_copy

            proposed = shallow_copy(live)
            proposed.status = shallow_copy(live.status)
            if status.get("phase"):
                proposed.status.phase = status["phase"]
            if status.get("podIP"):
                proposed.status.pod_ip = status["podIP"]
            if status.get("hostIP"):
                proposed.status.host_ip = status["hostIP"]
            try:
                self.server.admission.validate_only(AdmissionRequest(
                    UPDATE, "Pod", ns, proposed,
                    old_obj=live, user=user, subresource="status",
                ))
            except AdmissionError as e:
                return (422, "Invalid", str(e))
        if live is None:
            return (404, "NotFound", f"pod {name!r} not found")
        if status.get("phase") or status.get("podIP") \
                or status.get("hostIP"):
            store.set_pod_phase(
                ns, name,
                status.get("phase", ""),
                status.get("podIP", ""),
                status.get("hostIP", ""),
            )
        # scheduler-owned status fields (reference pod/status
        # strategy allows conditions + nominatedNodeName through the
        # status subresource — the scheduler's Unschedulable
        # condition and preemption nomination both write here)
        if "nominatedNodeName" in status:
            node = status["nominatedNodeName"]
            if node:
                store.set_nominated_node_name(ns, name, node)
            else:
                store.clear_nominated_node_name(ns, name)
        for cond in status.get("conditions") or ():
            from kubernetes_tpu_torch.api.types import PodCondition

            store.patch_pod_condition(
                ns, name,
                cond if not isinstance(cond, dict)
                else PodCondition(
                    type=cond.get("type", ""),
                    status=cond.get("status", ""),
                    reason=cond.get("reason", ""),
                    message=cond.get("message", ""),
                ))
        return None

    def _bulk_pod_status(self, ns: Optional[str]) -> None:
        """POST .../statuses with a PodStatusList: the bulk hot-path
        verb for status writes — mass-decline condition patches and
        kubelet phase sweeps ship N updates in one request instead of N
        round trips. Each item is its own transaction with the exact
        per-pod semantics of PUT pods/{name}/status
        (``_apply_pod_status``); failures come back positionally."""
        try:
            body = self._read_body()
        except json.JSONDecodeError as e:
            self._send_error(400, "BadRequest", f"invalid JSON: {e}")
            return
        items = body.get("items") if isinstance(body, dict) else None
        if not isinstance(items, list):
            self._send_error(400, "BadRequest",
                             "PodStatusList body with items required")
            return
        try:
            namespaces = {it.get("namespace") or ns or "default"
                          for it in items}
        except AttributeError:
            self._send_error(400, "BadRequest", "malformed status item")
            return
        try:
            user = None
            for item_ns in namespaces:
                user = self._check_authz("update", "pods/status", item_ns)
        except Forbidden as e:
            self._send_error(403, "Forbidden", str(e))
            return
        if user is None:
            user = self._user()
        if self._reshard_gate_bulk("Pod", [
                (it.get("namespace") or ns or "default",
                 it.get("name") or "") for it in items]):
            return
        applied = 0
        failures: List[dict] = []
        for i, it in enumerate(items):
            err = self._apply_pod_status(
                it.get("namespace") or ns or "default",
                it.get("name") or "",
                it.get("status") or {}, user)
            if err is None:
                applied += 1
            else:
                failures.append({"index": i, "code": err[0],
                                 "message": err[2]})
        self._send_negotiated(200, {
            "kind": "Status",
            "status": "Success" if not failures else "Failure",
            "applied": applied,
            "failures": failures,
        })

    def _trace_ingest(self, pods) -> None:
        """Stamp a ``rest.ingest`` instant event for each SAMPLED pod:
        the first hop of a pod's causal trace (REST → queue → solve →
        bind), keyed by pod uid so the scheduler-side spans stitch.
        A bulk request carries ONE propagated context (trace id = the
        batch's elected uid); that explicit inbound decision overrides
        local crc32 for exactly that pod — the rest of the batch keeps
        the deterministic local decision, which the sender made
        identically."""
        tracer = self.server.tracer
        if tracer is None or not tracer.enabled:
            return
        from kubernetes_tpu_torch.observability.tracer import (
            current_request_context)

        ctx = current_request_context()
        parent = tracer.current_span_id()
        for p in pods:
            uid = p.metadata.uid
            if not uid:
                continue
            inbound = ctx.sampled if ctx is not None \
                and ctx.trace == uid else None
            if tracer.sampled(uid, inbound=inbound):
                tracer.event(
                    "rest.ingest", trace=uid, parent_id=parent,
                    pod=f"{p.metadata.namespace}/{p.metadata.name}")

    def _bulk_create(self, kind: str, ns: Optional[str], body: dict,
                     user: str) -> None:
        """POST a {Kind}List to a collection: per-item admission, bulk
        store insert (one lock + one batched watch delivery for pods),
        positional failures. The QPS discipline lives client-side
        (RestClusterClient charges its token bucket per OBJECT, so a
        bulk request is rate-equivalent to N singles)."""
        store = self.server.store
        items = body.get("items")
        if not isinstance(items, list):
            self._send_error(400, "BadRequest", "List body without items")
            return
        failures: List[dict] = []
        decoded: List[tuple] = []    # (orig index, obj)
        for i, item in enumerate(items):
            try:
                # binary bodies carry API objects; JSON carries dicts
                obj = item if not isinstance(item, dict) \
                    else self._decode(item, kind)
                if ns is not None and store.kind_is_namespaced(kind):
                    obj.metadata.namespace = ns
                decoded.append((i, obj))
            except (ValueError, TypeError) as e:
                failures.append({"index": i, "code": 422,
                                 "message": str(e)})
        # the topology gate before admission charges anything: a bulk
        # create touching a frozen or moved slice is refused whole
        if self._reshard_gate_bulk(kind, [
                (o.metadata.namespace, o.metadata.name)
                for _, o in decoded]):
            return
        admitted: List[tuple] = []   # (orig index, AdmissionRequest, obj)
        for i, obj in decoded:
            try:
                req = AdmissionRequest(
                    CREATE, kind, obj.metadata.namespace, obj, user=user)
                obj = self.server.admission.run(req)
                admitted.append((i, req, obj))
            except (ValueError, TypeError, AdmissionError) as e:
                failures.append({"index": i, "code": 422,
                                 "message": str(e)})
        created = 0
        if admitted and kind == "Pod":
            try:
                store.create_pods([obj for _, _, obj in admitted])
                created = len(admitted)
                self._trace_ingest([obj for _, _, obj in admitted])
                admitted = []
            except ValueError:
                # mid-batch duplicate: create_pods inserted nothing
                # (it validates the whole batch first) — fall through
                # to per-item creates so the conflict is attributed
                # and the rest of the batch still lands
                pass
        if admitted and kind != "Pod":
            # one lock and one watch delivery for the batch: per-item
            # creates would let each of a bulk abuser's 200 items queue
            # every other writer behind it for the store's lock
            errors = store.create_objects_each(
                kind, [obj for _, _, obj in admitted])
            for (i, req, _), err in zip(admitted, errors):
                if err is None:
                    created += 1
                else:
                    self.server.admission.rollback(req)
                    failures.append({"index": i, "code": 409,
                                     "message": err})
            admitted = []
        for i, req, obj in admitted:
            try:
                store.create_pod(obj)
                self._trace_ingest([obj])
                created += 1
            except ValueError as e:
                self.server.admission.rollback(req)
                failures.append({"index": i, "code": 409,
                                 "message": str(e)})
        self._send_negotiated(201, {
            "kind": "Status",
            "status": "Success" if not failures else "Failure",
            "created": created,
            "failures": failures,
        })

    def do_POST(self) -> None:
        self._handle_write(self._do_POST)

    def _do_POST(self) -> None:
        if self._dispatch_admin("POST"):
            return
        if self._reject_if_read_only():
            return
        kind, ns, name, sub, q = self._route()
        if kind == "Lease":
            if sub == "acquire" and name is not None:
                # lease CAS verb (POST .../leases/{name}/acquire): the
                # in-process try_acquire_or_renew, made remote — hollow
                # kubelets' heartbeat leases and leader election over
                # the REST fabric. ``now`` is server-side on purpose:
                # one clock must arbitrate expiry across processes.
                try:
                    self._check_authz("update", "Lease", "")
                except Forbidden as e:
                    self._send_error(403, "Forbidden", str(e))
                    return
                try:
                    body = self._read_body()
                except json.JSONDecodeError as e:
                    self._send_error(400, "BadRequest",
                                     f"invalid JSON: {e}")
                    return
                holder = str(body.get("holder") or "")
                if not holder:
                    self._send_error(400, "BadRequest",
                                     "holder is required")
                    return
                acquired = self.server.store.try_acquire_or_renew(
                    name, holder, time.time(),
                    float(body.get("duration") or 15.0))
                self._send_json(200, {"acquired": bool(acquired),
                                      "holder": holder})
                return
            self._send_error(405, "MethodNotAllowed",
                             "Lease objects are read-only over REST")
            return
        if kind is None:
            path = urlparse(self.path).path.rstrip("/")
            if path.endswith("/bindings"):
                self._bulk_bindings(ns)
                return
            if path.endswith("/statuses"):
                self._bulk_pod_status(ns)
                return
            if path.endswith("/selfsubjectaccessreviews"):
                # virtual kind (reference authorization.k8s.io/v1
                # SelfSubjectAccessReview): any authenticated user may
                # ask "can I?" — the answer comes from the authorizer
                # seam, so it works for allow_all and RBAC alike
                try:
                    body = self._read_body()
                except json.JSONDecodeError as e:
                    self._send_error(400, "BadRequest", f"invalid JSON: {e}")
                    return
                user = self._user()
                attrs = (body.get("spec") or {}).get(
                    "resourceAttributes") or {}
                authz = self.server.authorizer
                if hasattr(authz, "authorize"):
                    allowed = authz.authorize(
                        user, attrs.get("verb", ""),
                        attrs.get("resource", ""),
                        attrs.get("namespace", ""), attrs.get("name", ""),
                    )
                else:
                    allowed = authz(
                        user, attrs.get("verb", ""),
                        attrs.get("resource", ""),
                        attrs.get("namespace", ""),
                    )
                self._send_json(201, {
                    "kind": "SelfSubjectAccessReview",
                    "apiVersion": "v1",
                    "status": {"allowed": bool(allowed)},
                })
                return
            self._send_error(404, "NotFound", f"no route for {self.path}")
            return
        try:
            body = self._read_body()
        except json.JSONDecodeError as e:
            self._send_error(400, "BadRequest", f"invalid JSON: {e}")
            return
        store = self.server.store
        # Binding subresource: POST .../pods/{name}/binding
        if kind == "Pod" and sub == "binding" and name is not None:
            if self._reshard_gate("Pod", ns, name):
                return
            try:
                self._check_authz("create", "Binding", ns or "")
                target = (body.get("target") or {}).get("name") or body.get("nodeName", "")
                store.bind(ns or "default", name, body.get("uid", ""), target)
                self._send_json(201, {"kind": "Status", "status": "Success"})
            except Forbidden as e:
                self._send_error(403, "Forbidden", str(e))
            except KeyError as e:
                self._send_error(404, "NotFound", str(e))
            except ValueError as e:
                self._send_error(409, "Conflict", str(e))
            return
        try:
            user = self._check_authz("create", kind, ns or "")
        except Forbidden as e:
            self._send_error(403, "Forbidden", str(e))
            return
        if name is None and isinstance(body, dict) \
                and body.get("kind") == f"{kind}List":
            self._bulk_create(kind, ns, body, user)
            return
        try:
            # binary bodies carry the API object itself; JSON carries
            # the wire dict
            obj = body if not isinstance(body, dict) \
                else self._decode(body, kind)
        except (ValueError, TypeError) as e:
            # decode failure (bad quantity, wrong shape) is the client's
            # fault — 400, never the store-conflict 409
            self._send_error(400, "BadRequest", str(e))
            return
        adm_req = None
        try:
            if ns is not None and store.kind_is_namespaced(kind):
                obj.metadata.namespace = ns
            if self._reshard_gate(kind, obj.metadata.namespace,
                                  obj.metadata.name):
                return
            adm_req = AdmissionRequest(
                CREATE, kind, obj.metadata.namespace, obj, user=user
            )
            obj = self.server.admission.run(adm_req)
            created = store.create_object(kind, obj)
            if kind == "Pod":
                self._trace_ingest([created])
            self._send_json(201, self._encode(created))
        except AdmissionError as e:
            # admission.run already unwound its own plugins' charges
            self._send_error(422, "Invalid", str(e))
        except ValueError as e:
            # create failed AFTER admission admitted (store conflict):
            # release the quota plugin's in-flight charge immediately
            if adm_req is not None:
                self.server.admission.rollback(adm_req)
            self._send_error(409, "AlreadyExists", str(e))

    def do_PUT(self) -> None:
        self._handle_write(self._do_PUT)

    def _do_PUT(self) -> None:
        if self._dispatch_admin("PUT"):
            return
        if self._reject_if_read_only():
            return
        kind, ns, name, sub, q = self._route()
        if kind == "Lease":
            self._send_error(405, "MethodNotAllowed",
                             "Lease objects are read-only over REST")
            return
        if kind is None or name is None:
            self._send_error(404, "NotFound", f"no route for {self.path}")
            return
        if self._reshard_gate(kind, ns, name):
            return
        try:
            body = self._read_body()
        except json.JSONDecodeError as e:
            self._send_error(400, "BadRequest", f"invalid JSON: {e}")
            return
        store = self.server.store
        # status subresource — phase/podIP only (kubelet status-manager path)
        if kind == "Pod" and sub == "status":
            try:
                # the subresource is its own authz vocabulary entry
                # (the node role grants "pods/status", not "pods")
                user = self._check_authz("update", "pods/status", ns or "")
            except Forbidden as e:
                self._send_error(403, "Forbidden", str(e))
                return
            err = self._apply_pod_status(ns or "default", name,
                                         body.get("status") or {}, user)
            if err is not None:
                self._send_error(*err)
                return
            self._send_json(200, {"kind": "Status", "status": "Success"})
            return
        try:
            user = self._check_authz("update", kind, ns or "")
        except Forbidden as e:
            self._send_error(403, "Forbidden", str(e))
            return
        try:
            obj = body if not isinstance(body, dict) \
                else self._decode(body, kind)
        except (ValueError, TypeError) as e:
            self._send_error(400, "BadRequest", str(e))
            return
        if obj.metadata.name and obj.metadata.name != name:
            # reference returns 400 when the body renames the URL's object
            self._send_error(
                400, "BadRequest",
                f"name in body ({obj.metadata.name!r}) must match URL ({name!r})",
            )
            return
        obj.metadata.name = name
        try:
            if ns is not None and store.kind_is_namespaced(kind):
                obj.metadata.namespace = ns
            old = store.get_object(kind, obj.metadata.namespace, name)
            if kind == "Service" and old is not None:
                # clusterIP is immutable (reference service strategy
                # ValidateUpdate); an omitted field keeps the assigned VIP
                if not obj.cluster_ip:
                    obj.cluster_ip = old.cluster_ip
                elif obj.cluster_ip != old.cluster_ip:
                    self._send_error(
                        422, "Invalid",
                        f"clusterIP is immutable (have {old.cluster_ip!r})",
                    )
                    return
            obj = self.server.admission.run(
                AdmissionRequest(
                    UPDATE, kind, obj.metadata.namespace, obj, old_obj=old, user=user
                )
            )
            # CAS expectation: the JSON wire carries it in metadata;
            # a binary body IS the object, so its stamped rv serves
            # (body.get on a pickled object would crash the handler)
            if isinstance(body, dict):
                expect = body.get("metadata", {}).get(
                    "resourceVersion") or None
            else:
                expect = obj.metadata.resource_version or None
            updated = store.update_object(kind, obj, expect_rv=expect)
            self._send_json(200, self._encode(updated))
        except AdmissionError as e:
            self._send_error(422, "Invalid", str(e))
        except ConflictError as e:
            self._send_error(409, "Conflict", str(e))
        except KeyError as e:
            self._send_error(404, "NotFound", str(e))

    def do_PATCH(self) -> None:
        self._handle_write(self._do_PATCH)

    def _do_PATCH(self) -> None:
        """PATCH with an RFC 7386 JSON Merge Patch (the default and
        ``application/merge-patch+json``), applied to the object's wire
        shape; an RFC 6902 JSON Patch is answered 415."""
        if self._dispatch_admin("PATCH"):
            return
        if self._reject_if_read_only():
            return
        kind, ns, name, sub, q = self._route()
        if kind == "Lease":
            self._send_error(405, "MethodNotAllowed",
                             "Lease objects are read-only over REST")
            return
        if kind is None or name is None or sub is not None:
            self._send_error(404, "NotFound", f"no route for {self.path}")
            return
        try:
            user = self._check_authz("patch", kind, ns or "")
        except Forbidden as e:
            self._send_error(403, "Forbidden", str(e))
            return
        try:
            body = self._read_body()
        except json.JSONDecodeError as e:
            self._send_error(400, "BadRequest", f"invalid JSON: {e}")
            return
        store = self.server.store
        old = store.get_object(kind, ns or "default", name)
        if old is None:
            self._send_error(404, "NotFound", f"{kind} {name!r} not found")
            return
        wire = self._encode(old)
        ctype = (self.headers.get("Content-Type") or "").split(";")[0]
        if ctype == "application/json-patch+json":
            self._send_error(415, "UnsupportedMediaType",
                             "JSON Patch is not served; use a merge patch")
            return
        try:
            patched = json_merge_patch(wire, body)
        except Exception as e:  # noqa: BLE001 — malformed patch
            self._send_error(400, "BadRequest", f"invalid patch: {e}")
            return
        if not isinstance(patched, dict):
            # a scalar merge-patch body replaces the whole document —
            # never a valid API object
            self._send_error(400, "BadRequest",
                             "patch result is not an object")
            return
        # identity is immutable under patch: name, uid, and creation
        # timestamp always come from the stored object (controllers key
        # on uid; a patch must never mint a new one)
        meta = patched.setdefault("metadata", {})
        if not isinstance(meta, dict):
            meta = patched["metadata"] = {}
        meta["name"] = name
        meta["uid"] = old.metadata.uid
        meta["creationTimestamp"] = old.metadata.creation_timestamp
        if kind == "Service" and old.cluster_ip and \
                patched.get("clusterIp") not in (None, old.cluster_ip):
            # same strategy check the PUT path enforces
            self._send_error(
                422, "Invalid",
                f"clusterIP is immutable (have {old.cluster_ip!r})",
            )
            return
        try:
            obj = self._decode(patched, kind)
            if ns is not None and store.kind_is_namespaced(kind):
                obj.metadata.namespace = ns
            obj = self.server.admission.run(AdmissionRequest(
                UPDATE, kind, obj.metadata.namespace, obj, old_obj=old,
                user=user,
            ))
            # CAS on the rv the patch was computed against: a
            # concurrent writer surfaces as 409, like GuaranteedUpdate
            updated = store.update_object(
                kind, obj, expect_rv=old.metadata.resource_version)
            self._send_json(200, self._encode(updated))
        except AdmissionError as e:
            self._send_error(422, "Invalid", str(e))
        except ConflictError as e:
            self._send_error(409, "Conflict", str(e))
        except (ValueError, TypeError) as e:
            self._send_error(400, "BadRequest", str(e))
        except KeyError as e:
            self._send_error(404, "NotFound", str(e))

    def do_DELETE(self) -> None:
        self._handle_write(self._do_DELETE)

    def _do_DELETE(self) -> None:
        if self._dispatch_admin("DELETE"):
            return
        if self._reject_if_read_only():
            return
        kind, ns, name, sub, q = self._route()
        if kind == "Lease":
            self._send_error(405, "MethodNotAllowed",
                             "Lease objects are read-only over REST")
            return
        if kind is None or name is None:
            self._send_error(404, "NotFound", f"no route for {self.path}")
            return
        if self._reshard_gate(kind, ns, name):
            return
        try:
            self._check_authz("delete", kind, ns or "")
        except Forbidden as e:
            self._send_error(403, "Forbidden", str(e))
            return
        old = self.server.store.get_object(kind, ns or "default", name)
        if old is not None:
            # DELETE dispatches through validating admission (there is
            # no body to mutate) — NodeRestriction confines a
            # node identity to deleting its own pods here
            try:
                self.server.admission.validate_only(AdmissionRequest(
                    DELETE, kind, ns or "default", old, old_obj=old,
                    user=self._user(),
                ))
            except AdmissionError as e:
                self._send_error(422, "Invalid", str(e))
                return
        if self.server.store.delete_object(kind, ns or "default", name):
            self._send_json(200, {"kind": "Status", "status": "Success"})
        else:
            self._send_error(404, "NotFound", f"{kind} {name!r} not found")

    # -- watch streaming ----------------------------------------------
    def _serve_watch(self, kind: str, ns: Optional[str], rv: int,
                     label_sel=None, field_checks=None) -> None:
        binary = self._accepts_binary()
        # a slow watcher is dropped (apiserver does the same), and
        # counted once: the sink runs under the store lock, so it never
        # blocks
        frames = _StreamQueue(WATCH_QUEUE_FRAMES, self._count_stream_drop)
        # capture the REQUEST's api version: the sink runs on store
        # threads, and group-route watches must stream the same wire
        # shape their GETs serve (versioned-codec contract)
        api_version = getattr(self, "_api_version", "v1")
        from kubernetes_tpu_torch.api.scheme import SCHEME_V

        def sink(event_rv: int, event: Event) -> None:
            if event.kind != kind:
                return
            if ns is not None and getattr(event.obj.metadata, "namespace", None) != ns:
                return
            # selector-scoped watch (storage-level filtering; deviation
            # from upstream: an object MODIFIED out of the selector is
            # dropped rather than translated to a synthetic DELETED)
            if label_sel is not None and not label_sel.matches(
                    event.obj.metadata.labels):
                return
            if field_checks is not None and not _field_checks_match(
                    event.obj, field_checks):
                return
            if binary:
                # the Event itself — pickled (once, cached on the event
                # across ALL binary watchers) by the writer thread, so
                # the store's dispatch path never pays an encode under
                # its lock and N watchers never pay N encodes; old_obj
                # rides along because scheduler event handlers key
                # bind/update detection on it (the reference's informers
                # synthesize old from their local cache instead — our
                # binary peers skip that cache)
                frames.put(event)
                return
            # memoized per event: N watchers must not pay N encodes
            # (reference cachingObject in the watch cache)
            frame = event.__dict__.get("_v1_frame") \
                if api_version == "v1" else None
            if frame is None:
                wire = SCHEME_V.encode(event.obj, api_version)
                doc = {"type": event.type, "object": wire}
                if event.ts:
                    # commit stamp for the freshness SLI (the JSON
                    # wire's analog of the binary 4-tuple)
                    doc["commitTs"] = event.ts
                frame = json.dumps(doc).encode() + b"\n"
                if api_version == "v1":
                    event.__dict__["_v1_frame"] = frame
            frames.put(frame)

        try:
            handle = self.server.watch_cache.watch_from(rv, sink)
        except TooOldResourceVersion as e:
            self._send_error(410, "Expired", str(e))
            return
        finally:
            # watch-init seats cover exactly the expensive part — the
            # replay/attach burst a reconnect herd multiplies. The
            # stream itself is long-running and must not hold seats
            # (upstream's watch-initialization seat model).
            ticket = self._apf_ticket
            if ticket is not None:
                ticket.release()
        from kubernetes_tpu_torch.apiserver import codec

        self.send_response(200)
        self.send_header(
            "Content-Type",
            codec.BINARY_CONTENT_TYPE if binary else "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self._send_codec_header()
        self.end_headers()
        # the stream's wire contract is pinned for its whole life: a
        # v1-pinned watcher gets legacy 3-tuple frames even though the
        # server's native frame is the 4-tuple (mixed-version roll)
        codec_version = getattr(self, "_codec_version",
                                codec.CODEC_VERSION)
        gate = self.server.fault_gate
        plural = KIND_TO_PLURAL.get(kind, kind.lower() + "s")

        def faults() -> bool:
            # per-frame watch faults: stalls delay delivery, drops abort
            # mid-stream with no terminating chunk (the client must
            # detect the loss and relist)
            if gate._rules:
                rule = gate.decide("GET", plural, watch=True)
                if rule is not None:
                    if rule.fault == "watch_stall":
                        time.sleep(rule.duration)
                    elif rule.fault == "watch_drop":
                        self._abort_socket()
                        return False
            return True

        if binary:
            # the backlog — plus a small flush window so a steady
            # producer fills the chunk instead of paying one syscall per
            # event — goes out as ONE length-prefixed frame: a pickled
            # list of per-event pickles (each cached on its Event,
            # shared across watchers). The client hands the whole batch
            # to its handler in one call (the store's own batched
            # dispatch, kept batched on the wire; reference streams
            # length-delimited protobuf).
            self._pump_stream(
                frames, handle,
                lambda batch: codec.frame(
                    [_cached_event_bytes(e, codec_version) for e in batch]),
                max_batch=2048, flush_window=WATCH_FLUSH_WINDOW,
                before_batch=faults)
        else:
            # JSON coalescing: several newline-delimited frames ride one
            # chunk write (readline-based clients parse them unchanged)
            # — syscalls per batch, not per event
            self._pump_stream(frames, handle, b"".join,
                              before_batch=faults)

    def _count_stream_drop(self) -> None:
        self.server.watch_drops += 1

    def _write_chunk(self, body: bytes) -> None:
        self.wfile.write(b"%x\r\n%s\r\n" % (len(body), body))

    def _pump_stream(self, frames: _StreamQueue, handle,
                     encode: Callable[[List[Any]], bytes],
                     max_batch: int = 512, flush_window: float = 0.0,
                     before_batch: Optional[Callable[[], bool]] = None,
                     head: bytes = b"") -> None:
        """Write a stream's chunks until the server stops or fences, the
        socket dies, ``before_batch`` says stop, or the stream, cut as
        slow, has sent its queue. ``head`` goes first; then each turn takes the backlog
        (up to ``max_batch`` frames, waiting ``flush_window`` for more)
        and writes ``encode(batch)`` as one chunk. Stops ``handle`` and
        writes the closing chunk on the way out."""
        try:
            if head:
                self._write_chunk(head)
                self.wfile.flush()
            while not self.server.stopping.is_set():
                if self._sock_aborted:
                    # an injected fault (truncation mid-stream) killed
                    # the socket: writes now land in _DevNullWriter and
                    # never raise, so exit explicitly or this thread
                    # would drain a dead subscription forever
                    break
                if self.server.fenced.is_set():
                    # a replica that fences mid-stream sheds its
                    # watchers: the client relists, the fence answers
                    # the list 503, and the stream lands on a sibling
                    break
                if frames.cut and frames.frames.empty():
                    # what was written is a prefix of the commit order:
                    # the reader resumes from its newest version
                    break
                try:
                    batch = [frames.frames.get(timeout=0.5)]
                except queue.Empty:
                    continue
                if before_batch is not None and not before_batch():
                    break
                deadline = None
                while len(batch) < max_batch:
                    try:
                        batch.append(frames.frames.get_nowait())
                        continue
                    except queue.Empty:
                        pass
                    if deadline is None:
                        deadline = time.monotonic() + flush_window
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    try:
                        batch.append(frames.frames.get(timeout=left))
                    except queue.Empty:
                        break
                self._write_chunk(encode(batch))
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            handle.stop()
            try:
                self.wfile.write(b"0\r\n\r\n")
            except OSError:
                pass

    # -- the read tier's commit stream (apiserver/readtier.py) ---------
    def _serve_subscription(self, u) -> None:
        """The commit stream read replicas follow: every watch event of
        every kind as an NDJSON line ``{type, kind, rv, object,
        commitTs}``, from ``resourceVersion`` on. The resume comes from
        the watch cache (replay and live attach under one lock) or, when
        the cache no longer holds the window (a restarted owner's cache
        is empty), from the WAL; only when both are compacted past the
        cursor is the answer 410, and the replica seeds again from
        ``?snapshot=1``."""
        q = {k: v[0] for k, v in parse_qs(u.query).items()}
        if q.get("snapshot") in ("1", "true"):
            self._serve_subscription_snapshot()
            return
        try:
            rv = int(q.get("resourceVersion") or 0)
        except ValueError:
            self._send_error(
                400, "BadRequest",
                f"invalid resourceVersion {q.get('resourceVersion')!r}")
            return
        # a replica that cannot keep up is cut rather than stalling the
        # owner's dispatch; it resumes from its cursor, or seeds again
        frames = _StreamQueue(SUBSCRIPTION_QUEUE_FRAMES,
                              self._count_stream_drop)

        def sink(event_rv: int, event: Event) -> None:
            # one encode an event, shared by every subscribed replica
            frame = event.__dict__.get("_sub_frame")
            if frame is None:
                doc = {"type": event.type, "kind": event.kind,
                       "rv": event_rv, "object": to_wire(event.obj)}
                if event.ts:
                    doc["commitTs"] = event.ts
                frame = json.dumps(doc).encode() + b"\n"
                event.__dict__["_sub_frame"] = frame
            frames.put(frame)

        replayed: List[bytes] = []
        handle = None
        try:
            try:
                handle = self.server.watch_cache.watch_from(rv, sink)
            except TooOldResourceVersion:
                handle = self._attach_via_wal(rv, sink, replayed)
            if handle is None:
                self._send_error(
                    410, "Expired",
                    f"resourceVersion {rv} is compacted out of both the "
                    "watch cache and the WAL — reseed from ?snapshot=1")
                return
        finally:
            ticket = self._apf_ticket
            if ticket is not None:
                ticket.release()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        self._pump_stream(frames, handle, b"".join, head=b"".join(replayed))

    def _attach_via_wal(self, rv: int, sink, replayed: List[bytes]):
        """A subscription resume the watch cache cannot cover: the WAL's
        window (rv, end] encoded into ``replayed``, then the live sink
        attached at the window's top (an event committed while the log
        was read is newer and replays from the cache). Returns the live
        handle, or None when the WAL cannot cover the window either."""
        wal_dir = self.server.wal_dir
        if not wal_dir:
            return None
        from kubernetes_tpu_torch.apiserver.wal import wal_events_since

        try:
            covered, entries = wal_events_since(wal_dir, rv)
        except OSError:
            return None
        if not covered:
            return None
        top = rv
        for line in entries:
            line_rv = int(line.get("rv") or 0)
            doc: Dict[str, Any] = {"rv": line_rv, "kind": line["k"]}
            if line["t"] == "DEL":
                # the log keeps no body for a delete: the replica pops
                # its mirrored object and announces it at this version
                doc["type"] = "DELETED"
                doc["key"] = [line.get("ns", ""), line["n"]]
            else:
                doc["type"] = "MODIFIED"
                doc["object"] = line["o"]
            replayed.append(json.dumps(doc).encode() + b"\n")
            top = max(top, line_rv)
        try:
            return self.server.watch_cache.watch_from(top, sink)
        except TooOldResourceVersion:
            return None

    def _serve_subscription_snapshot(self) -> None:
        """A replica's seed: a leading ``{"rv": R}`` line, R read before
        any kind is listed, then each kind's objects in batches of 500.
        Events between R and a kind's list come again on the
        subscription from R; the replica's per-object version guard
        drops them."""
        store = self.server.store
        rv0 = store.current_rv()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def write_line(doc: dict) -> None:
            self._write_chunk(json.dumps(doc).encode() + b"\n")

        try:
            write_line({"rv": rv0})
            for kind in store.known_kinds():
                if kind == "Lease":
                    # no watch event keeps a mirrored lease current
                    continue
                try:
                    objs, krv = store.list_objects_with_rv(kind)
                except KeyError:
                    continue
                if not objs:
                    continue
                for i in range(0, len(objs), 500):
                    write_line({
                        "kind": kind, "rv": krv,
                        "objects": [to_wire(o) for o in objs[i:i + 500]],
                    })
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass

    def _reject_if_read_only(self) -> bool:
        """True when this server is a read replica and the mutating
        request was answered 503 with ``X-Replica-ReadOnly``: writes go
        to the partition owner. The body is read first, so the
        connection's framing survives for the next request."""
        if not self.server.read_only:
            return False
        length = self._content_length()
        if length and not self._body_consumed:
            self.rfile.read(length)
            self._body_consumed = True
        self._send_error(
            503, "ReadOnlyReplica",
            "read replica serves no writes — route mutations to the "
            "partition owner", {"X-Replica-ReadOnly": "1"})
        return True


class APIServer(ThreadingHTTPServer):
    """The apiserver: serves a ClusterStore over REST; start with
    ``.start()``, stop with ``.shutdown_server()``."""

    daemon_threads = True
    # an informer herd (re)connects in bursts of hundreds; the default
    # listen backlog of 5 would turn that into connection-refused churn
    request_queue_size = 512

    def __init__(
        self,
        store: Optional[ClusterStore] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        authorizer: Authorizer = allow_all,
        tokens: Optional[Dict[str, str]] = None,
        max_readonly_inflight: Optional[int] = 400,
        max_mutating_inflight: Optional[int] = 200,
        flow_control: Optional[str] = "default",
        partition: Optional[Tuple[int, int]] = None,
        read_only: bool = False,
        fault_gate: Optional[FaultGate] = None,
    ):
        super().__init__((host, port), _Handler)
        # a read replica (``apiserver/readtier.py``) serves reads from its
        # mirror store and answers every write 503. ``fenced`` is its
        # staleness breaker: set while its replication lag is over budget,
        # reads answer 503 (X-Replica-Fenced) and live watch streams
        # close. ``wal_dir``, set by a caller that attached a WAL, lets
        # the subscription route resume windows the watch cache lost
        self.read_only = bool(read_only)
        self.fenced = threading.Event()
        self.wal_dir: Optional[str] = None
        # (index, count) when this server is one partition of the
        # partitioned control plane, its store holding only that
        # partition's keyspace; (0, 1) is the unpartitioned server
        self.partition_index, self.partition_count = partition or (0, 1)
        # the elastic control plane: the live topology (None: the static
        # layout), the slices frozen by a migration (slot -> (deadline,
        # eta)), and the per-slot and per-namespace write ledgers the
        # rebalancer reads
        self.partition_topology: Optional[Any] = None
        self._topology_lock = threading.Lock()
        self.frozen_slots: Dict[int, Tuple[float, float]] = {}
        # the writes that passed the topology gate and have not answered
        # yet, by ticket: a freeze waits for those that passed before it
        # (the drain), so no write it let through commits after a
        # migration's copy or an upgrade's WAL snapshot
        self.write_gate = threading.Condition()
        self._write_tickets = 0
        self.open_writes: set = set()
        self.slot_writes: Dict[int, int] = {}
        self.ns_writes: Dict[str, int] = {}
        # watch streams dropped for a full frame queue (a slow watcher)
        self.watch_drops = 0
        # pre-encoded list responses (binary, selector-free), validated
        # by the store's per-kind mutation counter: a scheduler relist
        # of 5k nodes while only pods churn costs one cache hit, not a
        # 5k-object pickle
        self._list_cache: Dict[tuple, tuple] = {}
        self._list_cache_lock = threading.Lock()
        # the newest version a list of each kind was taken at: a cached
        # list of another namespace older than it is listed again
        self._list_newest_rv: Dict[str, int] = {}
        # authz decision cache, invalidated by RBAC object events
        self._authz_cache: Dict[tuple, bool] = {}
        # chaos middleware: always present (a rule-less gate costs one
        # attribute read per request) so /debug/faults can arm it at
        # runtime without a server restart; ``fault_gate`` hands in one
        # armed already
        self.fault_gate = fault_gate if fault_gate is not None \
            else FaultGate()
        # flight recorder: the process-wide tracer, so an in-process
        # scheduler's spans and this server's request spans land in ONE
        # ring and /debug/trace serves the stitched picture
        from kubernetes_tpu_torch.observability.tracer import get_tracer

        self.tracer = get_tracer()
        import itertools

        self._req_seq = itertools.count()   # 1-in-N request-span sampling
        # how many requests arrived with an X-Ktpu-Trace header
        self.trace_headers_seen = 0
        # self-protection lanes (--max-requests-inflight 400,
        # --max-mutating-requests-inflight 200); None = unlimited.
        # Active only when flow_control=None — APF replaces them as the
        # admission decision otherwise, deriving its seat budgets from
        # the same numbers.
        self.readonly_lane = threading.Semaphore(max_readonly_inflight) \
            if max_readonly_inflight else None
        self.mutating_lane = threading.Semaphore(max_mutating_inflight) \
            if max_mutating_inflight else None
        self.lane_stats = {"ro": LaneStats(max_readonly_inflight),
                           "rw": LaneStats(max_mutating_inflight)}
        # API Priority & Fairness (flowcontrol.py): the default
        # admission path: "default" derives the standard schema/level
        # tiering from the lane budgets; None restores the raw lanes.
        if flow_control is None:
            self.flowcontrol: Optional[FlowController] = None
        else:
            self.flowcontrol = FlowController(default_config(
                max_readonly_inflight, max_mutating_inflight))
        self.store = store if store is not None else ClusterStore()
        self.watch_cache = WatchCache(self.store)
        from kubernetes_tpu_torch.apiserver.admission import (
            DefaultStorageClass,
            NamespaceLifecycle,
            NodeRestriction,
            PodPriorityResolver,
            ResourceQuotaAdmission,
            ServiceAccountAdmission,
        )

        admission = AdmissionChain.default()
        # store-backed plugins: namespace lifecycle rejects creates into
        # Terminating namespaces; priority classes resolve from
        # PriorityClass objects
        for p in admission.plugins:
            if isinstance(p, (NamespaceLifecycle, PodPriorityResolver)):
                p.store = self.store
        admission.plugins.append(ServiceAccountAdmission(self.store))
        admission.plugins.append(NodeRestriction())
        admission.plugins.append(DefaultStorageClass(self.store))
        admission.plugins.append(ResourceQuotaAdmission(self.store))
        self.admission = admission
        self.authorizer = authorizer
        self.tokens = dict(tokens or {})  # bearer token -> username

        _AUTHZ_KINDS = frozenset((
            "Role", "ClusterRole", "RoleBinding", "ClusterRoleBinding"))

        def _maybe_invalidate(events) -> None:
            if any(e.kind in _AUTHZ_KINDS for e in events):
                # policy changed: cached allow/deny decisions are void
                # (rebinding the dict is atomic: readers see either the
                # old or the fresh empty map)
                self._authz_cache = {}

        self._authz_watch = self.store.watch(_maybe_invalidate)
        self.stopping = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # live client sockets: shutdown() only stops the accept loop,
        # so a stopped server closes these too
        self._conn_lock = threading.Lock()
        self._live_conns: set = set()

    def authorize_cached(self, user: str, verb: str, kind: str,
                         namespace: str) -> bool:
        """Authz with a decision cache in front: hot-path requests from
        the same identity repeat the same (verb, kind, ns) triple
        thousands of times per second, and the RBAC walk costs a store
        lock + binding scan each time. Invalidated by RBAC object
        events and by static-group edits (``policy_gen``)."""
        authorizer = self.authorizer
        if authorizer is allow_all:
            return True
        gen = getattr(authorizer, "policy_gen", 0)
        key = (user, verb, kind, namespace, gen)
        cache = self._authz_cache
        hit = cache.get(key)
        if hit is not None:
            return hit
        ok = bool(authorizer(user, verb, kind, namespace))
        # write into the SNAPSHOT captured before the walk: a policy
        # invalidation that raced it rebinds the live dict, and the
        # stale decision must land in the discarded one. On overflow,
        # reset the live dict only if it still IS the snapshot.
        if len(cache) >= 8192 and cache is self._authz_cache:
            self._authz_cache = {}
            return ok
        cache[key] = ok
        return ok

    def cached_list_binary(self, kind: str,
                           namespace: Optional[str]) -> bytes:
        """Pre-encoded binary list response for (kind, namespace),
        validated against the store's per-kind mutation counter: while
        the KIND is unchanged the pickled body is byte-identical, so a
        reflector relist of 5k nodes during pod churn costs a dict hit
        instead of a 5k-object encode. The seq is read BEFORE listing —
        a write racing the encode caches a newer body under an older
        seq, which can only cause a spurious miss, never a stale hit.

        The cached body also carries the rv it listed at: once OTHER
        kinds' churn compacts the watch log past that rv, serving it
        would strand the reflector in a relist→410 loop (its watch from
        the stale rv can never attach) — such entries re-list at the
        current rv instead.

        Nor is a hit served whose rv is older than a list of the same
        kind already taken (another namespace's, or all namespaces'): a
        client that listed both would see the kind's version go back.
        It is listed again, once, at the current rv."""
        from kubernetes_tpu_torch.apiserver import codec

        seq = self.store.kind_seq(kind)
        key = (kind, namespace)
        with self._list_cache_lock:
            hit = self._list_cache.get(key)
            newest = self._list_newest_rv.get(kind, 0)
        if hit is not None and hit[0] == seq and hit[2] >= newest:
            oldest = self.watch_cache.oldest_rv()
            if oldest is None or hit[2] >= oldest - 1:
                return hit[1]
        objs, rv = self.store.list_objects_with_rv(kind, namespace)
        if self.flowcontrol is not None:
            self.flowcontrol.width.note_list_size(
                KIND_TO_PLURAL.get(kind, kind.lower() + "s"), len(objs))
        body = codec.encode(
            {"kind": f"{kind}List", "resourceVersion": rv, "items": objs})
        with self._list_cache_lock:
            if len(self._list_cache) >= 64:
                self._list_cache.clear()
            # two misses racing: the one that listed later wins, or a
            # hit could serve a version older than a list already sent
            cur = self._list_cache.get(key)
            if cur is None or cur[2] <= rv:
                self._list_cache[key] = (seq, body, rv)
            if rv > self._list_newest_rv.get(kind, 0):
                self._list_newest_rv[kind] = rv
        return body

    def metrics_text(self) -> str:
        try:
            from kubernetes_tpu_torch.metrics import default_registry

            return default_registry().expose()
        except Exception:
            return ""

    @property
    def port(self) -> int:
        return self.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.server_address[0]}:{self.port}"

    def install_topology(self, topology) -> bool:
        """Install a (newer) live partition topology. Epoch-monotonic:
        a replayed or stale install is refused, so a torn coordinator
        can never roll a server's routing backwards. Installing also
        updates the served partition count and drops frozen slices this
        server no longer owns (their freeze belonged to the migration
        that just committed)."""
        with self._topology_lock:
            cur = self.partition_topology
            if cur is not None and topology.epoch <= cur.epoch:
                return False
            self.partition_topology = topology
            self.partition_count = topology.partitions
            for slot in list(self.frozen_slots):
                if topology.owner[slot] != self.partition_index:
                    self.frozen_slots.pop(slot, None)
            return True

    def open_write(self) -> int:
        """A ticket for a write that just passed the topology gate; the
        caller holds ``write_gate``."""
        self._write_tickets += 1
        self.open_writes.add(self._write_tickets)
        return self._write_tickets

    def close_write(self, ticket: int) -> None:
        with self.write_gate:
            self.open_writes.discard(ticket)
            self.write_gate.notify_all()

    def freeze_and_drain(self, slots, eta: float) -> bool:
        """Freeze ``slots`` for ``eta`` seconds, then wait, within that
        window, for every write the gate let through before the freeze
        to answer. True when they all did."""
        deadline = time.monotonic() + eta
        with self.write_gate:
            for s in slots:
                self.frozen_slots[int(s)] = (deadline, eta)
            passed = set(self.open_writes)
            while passed & self.open_writes:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self.write_gate.wait(remaining)
        return True

    def invalidate_list_caches(self) -> None:
        """Drop the pre-encoded list cache (adopt/evict bump kind_seq,
        which already invalidates it — this is the belt to that
        suspender for mixed-version callers)."""
        with self._list_cache_lock:
            self._list_cache.clear()

    def start(self) -> "APIServer":
        self._thread = threading.Thread(
            target=self.serve_forever, name="apiserver", daemon=True
        )
        self._thread.start()
        return self

    def handle_error(self, request, client_address):
        # a dropped client connection is normal fabric weather (pool
        # churn, chaos kills, severed keep-alives) — not worth a
        # stderr traceback; anything else keeps the default report
        import sys

        exc = sys.exc_info()[1]
        if isinstance(exc, (ConnectionError, BrokenPipeError)) \
                or self.stopping.is_set():
            return
        super().handle_error(request, client_address)

    def process_request(self, request, client_address):
        with self._conn_lock:
            self._live_conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._conn_lock:
            self._live_conns.discard(request)
        super().shutdown_request(request)

    def sever_connections(self) -> None:
        """Close every live client connection — the in-proc equivalent
        of a SIGKILLed process dropping its sockets. Without this an
        in-proc 'kill' leaves keep-alive clients being served by the
        dead server's surviving handler threads, and chaos cells that
        assert re-route behavior would pass against a zombie."""
        with self._conn_lock:
            conns = list(self._live_conns)
            self._live_conns.clear()
        for s in conns:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass

    def shutdown_server(self) -> None:
        self.stopping.set()
        self.shutdown()
        self.watch_cache.stop()
        self._authz_watch.stop()
        if self._thread is not None:
            self._thread.join(timeout=5)


# ---------------------------------------------------------------------------
# Client (the remote face of client-go's RESTClient + watch package)


class WatchHandle:
    def __init__(self):
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._resp = None

    def stop(self) -> None:
        self._stop.set()
        # Force the blocked readline() to return so the thread, socket,
        # and the server-side sink registration are all released. Must be
        # socket.shutdown, NOT resp.close(): close() needs the buffered-
        # reader lock the blocked readline() holds → deadlock.
        import socket as _socket

        resp = self._resp
        sock = getattr(getattr(resp, "fp", None), "raw", None)
        sock = getattr(sock, "_sock", None)
        if sock is not None:
            try:
                sock.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass


class RestClient:
    """Typed HTTP client. list/watch feed the same informer machinery the
    in-process store feeds (reference client-go RESTClient +
    tools/watch)."""

    def __init__(self, base_url: str, token: str = ""):
        self.base_url = base_url.rstrip("/")
        self.token = token

    # -- low-level -----------------------------------------------------
    def _request(self, method: str, path: str, body: Any = None,
                 content_type: str = "application/json"):
        import urllib.error
        import urllib.request

        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.base_url + path, data=data, method=method
        )
        req.add_header("Content-Type", content_type)
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return resp.status, json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"{}")


    def _path(self, kind: str, namespace: Optional[str], name: Optional[str] = None,
              sub: Optional[str] = None) -> str:
        plural = KIND_TO_PLURAL.get(kind) or kind.lower() + "s"
        p = f"/api/v1/namespaces/{namespace}/{plural}" if namespace else f"/api/v1/{plural}"
        if name:
            p += f"/{name}"
        if sub:
            p += f"/{sub}"
        return p

    @staticmethod
    def _raise_for(code: int, payload: Any) -> None:
        if code < 400:
            return
        msg = payload.get("message", "") if isinstance(payload, dict) else str(payload)
        if code == 404:
            raise KeyError(msg)
        if code == 409:
            raise ConflictError(msg)
        if code in (403, 422):
            raise PermissionError(msg)
        raise RuntimeError(f"HTTP {code}: {msg}")


    def create(self, obj) -> Any:
        kind = type(obj).__name__
        ns = obj.metadata.namespace if is_namespaced(kind) else None
        code, payload = self._request(
            "POST", self._path(kind, ns), to_wire(obj)
        )
        self._raise_for(code, payload)
        return from_wire(payload, kind)

    def get(self, kind: str, name: str, namespace: Optional[str] = "default"):
        ns = namespace if is_namespaced(kind) else None
        code, payload = self._request("GET", self._path(kind, ns, name))
        if code == 404:
            return None
        self._raise_for(code, payload)
        return from_wire(payload, kind)

    def list(self, kind: str, namespace: Optional[str] = None,
             label_selector: str = "",
             field_selector: str = "") -> Tuple[List[Any], int]:
        """→ (objects, listResourceVersion) for watch bootstrapping.
        Selectors filter SERVER-side (?labelSelector= / ?fieldSelector=),
        like client-go ListOptions."""
        from urllib.parse import urlencode

        path = self._path(kind, namespace)
        params = {}
        if label_selector:
            params["labelSelector"] = label_selector
        if field_selector:
            params["fieldSelector"] = field_selector
        if params:
            path += "?" + urlencode(params)
        code, payload = self._request("GET", path)
        self._raise_for(code, payload)
        rv = int(payload.get("metadata", {}).get("resourceVersion") or 0)
        return [from_wire(item, kind) for item in payload.get("items", [])], rv

    def update(self, obj) -> Any:
        kind = type(obj).__name__
        ns = obj.metadata.namespace if is_namespaced(kind) else None
        code, payload = self._request(
            "PUT", self._path(kind, ns, obj.metadata.name), to_wire(obj)
        )
        self._raise_for(code, payload)
        return from_wire(payload, kind)

    def delete(self, kind: str, name: str, namespace: Optional[str] = "default") -> bool:
        """True = deleted, False = not found; authorization and
        admission failures raise (a 403/422 must never read as a
        routine miss)."""
        ns = namespace if is_namespaced(kind) else None
        code, payload = self._request("DELETE", self._path(kind, ns, name))
        if code in (403, 422):
            self._raise_for(code, payload)
        return code == 200

    def patch(self, kind: str, name: str, patch: Any,
              namespace: Optional[str] = "default") -> Any:
        """PATCH with an RFC 7386 merge patch."""
        ns = namespace if is_namespaced(kind) else None
        code, payload = self._request(
            "PATCH", self._path(kind, ns, name), patch,
            content_type="application/merge-patch+json")
        self._raise_for(code, payload)
        return from_wire(payload, kind)


    def bind(self, namespace: str, name: str, uid: str, node_name: str) -> None:
        code, payload = self._request(
            "POST",
            self._path("Pod", namespace, name, "binding"),
            {"kind": "Binding", "target": {"name": node_name}, "uid": uid},
        )
        self._raise_for(code, payload)

    def update_pod_status(self, namespace: str, name: str, phase: str,
                          pod_ip: str = "", host_ip: str = "") -> None:
        code, payload = self._request(
            "PUT",
            self._path("Pod", namespace, name, "status"),
            {"status": {"phase": phase, "podIP": pod_ip, "hostIP": host_ip}},
        )
        self._raise_for(code, payload)

    def can_i(self, verb: str, resource: str, namespace: str = "",
              name: str = "") -> bool:
        """SelfSubjectAccessReview: ask the server whether the caller's
        token may perform verb on resource (authorization.k8s.io)."""
        code, payload = self._request(
            "POST", "/api/v1/selfsubjectaccessreviews",
            {
                "kind": "SelfSubjectAccessReview",
                "spec": {"resourceAttributes": {
                    "verb": verb, "resource": resource,
                    "namespace": namespace, "name": name,
                }},
            },
        )
        self._raise_for(code, payload)
        return bool((payload.get("status") or {}).get("allowed"))

    def healthz(self) -> bool:
        import urllib.request

        try:
            with urllib.request.urlopen(self.base_url + "/healthz", timeout=5) as r:
                return r.status == 200
        except Exception:
            return False

    # -- watch ---------------------------------------------------------
    def watch(
        self,
        kind: str,
        resource_version: int,
        fn: Callable[[str, Any], None],
        namespace: Optional[str] = None,
        on_expired: Optional[Callable[[], None]] = None,
    ) -> WatchHandle:
        """Stream watch events; fn(type, obj) per frame on a daemon
        thread. On HTTP 410 (compacted RV) calls on_expired and exits —
        the reflector's relist trigger."""
        import urllib.error
        import urllib.request

        handle = WatchHandle()
        path = self._path(kind, namespace) + f"?watch=true&resourceVersion={resource_version}"
        req = urllib.request.Request(self.base_url + path)
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")

        def run() -> None:
            try:
                resp = urllib.request.urlopen(req)
            except urllib.error.HTTPError as e:
                if e.code == 410 and on_expired is not None:
                    on_expired()
                return
            handle._resp = resp
            if handle._stop.is_set():
                resp.close()
                return
            with resp:
                try:
                    while not handle._stop.is_set():
                        line = resp.readline()
                        if not line:
                            break
                        line = line.strip()
                        if not line:
                            continue
                        frame = json.loads(line)
                        fn(frame["type"], from_wire(frame["object"], kind))
                except (OSError, ValueError, json.JSONDecodeError):
                    # connection closed (possibly mid-frame) by stop()
                    pass

        handle._thread = threading.Thread(target=run, daemon=True, name=f"watch-{kind}")
        handle._thread.start()
        return handle
