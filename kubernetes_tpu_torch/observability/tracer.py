"""Span recorder and bounded flight recorder with Perfetto export.

- Recording takes no tracer lock: a finished span is one tuple appended
  to a ``deque(maxlen=...)``; the only lock per span is the phase
  histogram's. Per-pod spans are head-sampled.
- Sampling is deterministic: a pod is in or out by ``crc32(seed:uid)``,
  so every component decides alike for the same pod. Cycle-level spans
  (one encode, device, commit span a batch) are always recorded.
- The ring is bounded by event count, and dumps keep only the trailing
  ``retain_s`` window.

Span times are monotonic; the dump carries the wall-clock anchor. Export
is Chrome ``trace_event`` JSON (``{"traceEvents": [...]}``), which loads
in https://ui.perfetto.dev and ``chrome://tracing``.

``KTPU_TRACE=off`` disables the process tracer, ``KTPU_TRACE_SAMPLE``
sets its sample rate (a probability, or a denominator such as ``64``),
and ``KTPU_TRACE_DUMP_DIR`` arms its crash dump. REST requests carry
a sampled pod's context in the ``X-Ktpu-Trace`` header; the server sets
it as the request's context for the handler's thread
(``set_request_context``), where the store's dispatch stamps it on the
events the request commits.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
import zlib
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

# Fleet trace propagation: a request may carry this header so a pod
# sampled at the ingesting client is sampled in every process it
# touches. Format: ``<trace>;<parent_span_id>;<0|1>`` —
# trace id (pod uid where one exists), the sender's span id (kept as a
# span ATTRIBUTE by the receiver, since span-id counters are
# per-process and collide across the fleet), and the explicit sampling
# decision (crc32 head sampling re-derived per-process agrees for pod
# uids, but bulk verbs and control-plane calls need the bit).
TRACE_HEADER = "X-Ktpu-Trace"


class TraceContext(NamedTuple):
    """A parsed ``X-Ktpu-Trace`` header: the wire form of one hop of a
    fleet trace."""

    trace: str
    parent: int
    sampled: bool

    def header_value(self) -> str:
        return format_trace_header(self.trace, self.parent, self.sampled)


def format_trace_header(trace: str, parent: int = 0,
                        sampled: bool = True) -> str:
    """Serialize a trace context for the ``X-Ktpu-Trace`` header.
    Semicolons in the trace id would corrupt the frame; uids never
    contain them, but defend anyway."""
    return (f"{str(trace).replace(';', '_')};{int(parent)};"
            f"{1 if sampled else 0}")


def parse_trace_header(value: Optional[str]) -> Optional[TraceContext]:
    """Parse an ``X-Ktpu-Trace`` header value; returns None on any
    malformed input (propagation is best-effort by contract — a bad
    header must never fail the request that carried it)."""
    if not value:
        return None
    try:
        trace, parent, sampled = value.split(";", 2)
        if not trace or sampled.strip() not in ("0", "1"):
            return None
        return TraceContext(trace, int(parent), sampled.strip() == "1")
    except (ValueError, AttributeError):
        return None


# The inbound request context of the handler running on this thread
# (one request per thread), read where the store stamps the events a
# request commits.
_request_ctx = threading.local()


def set_request_context(ctx: Optional[TraceContext]) -> None:
    _request_ctx.ctx = ctx


def current_request_context() -> Optional[TraceContext]:
    return getattr(_request_ctx, "ctx", None)


# record layout (tuples, not objects: ~3x cheaper to build and they
# never need mutation once finished)
# (name, ph, t_end_mono, dur_s, trace, span_id, parent_id, tid, attrs)
_PH_SPAN = "X"
_PH_INSTANT = "i"

DEFAULT_MAX_EVENTS = 65536
DEFAULT_RETAIN_S = 60.0
DEFAULT_SAMPLE_RATE = 1.0 / 64.0

_SAMPLE_DENOM = float(1 << 32)


class Span:
    """An in-flight span handle (finished spans live as tuples in the
    ring). Use via ``Tracer.span(...)`` as a context manager."""

    __slots__ = ("tracer", "name", "trace", "attrs", "span_id",
                 "parent_id", "t0")

    def __init__(self, tracer: "Tracer", name: str, trace: str,
                 attrs: Optional[dict], span_id: int, parent_id: int):
        self.tracer = tracer
        self.name = name
        self.trace = trace
        self.attrs = attrs
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = time.monotonic()

    def __enter__(self) -> "Span":
        self.tracer._push(self)
        return self

    def __exit__(self, *exc) -> bool:
        self.tracer._pop_and_record(self)
        return False

    def set(self, **attrs) -> None:
        if self.attrs is None:
            self.attrs = {}
        self.attrs.update(attrs)


class Tracer:
    def __init__(
        self,
        component: str = "scheduler",
        sample_rate: Optional[float] = None,
        seed: int = 0,
        max_events: int = DEFAULT_MAX_EVENTS,
        retain_s: float = DEFAULT_RETAIN_S,
        registry=None,
        enabled: bool = True,
        dump_dir: Optional[str] = None,
    ):
        self.component = component
        self.enabled = enabled
        if sample_rate is None:
            sample_rate = _env_sample_rate()
        self.sample_rate = float(sample_rate)
        self.seed = int(seed)
        self._seed_prefix = f"{self.seed}:".encode()
        self._sample_cut = int(self.sample_rate * _SAMPLE_DENOM)
        self.retain_s = float(retain_s)
        self.max_events = int(max_events)
        self._ring: deque = deque(maxlen=self.max_events)
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._tids: Dict[int, str] = {}
        self._epoch_mono = time.monotonic()
        self._epoch_wall = time.time()
        self._dump_dir = dump_dir or os.environ.get("KTPU_TRACE_DUMP_DIR")
        self._dump_seq = itertools.count(1)
        self._dump_lock = threading.Lock()
        self._last_dump_mono: Dict[str, float] = {}
        self._last_dump_paths: Dict[str, str] = {}
        self.last_dump_path: Optional[str] = None
        self._crash_armed = False
        self._phase_hist = _phase_histogram(registry)

    # -- sampling ------------------------------------------------------
    def sampled(self, uid: str, inbound: Optional[bool] = None) -> bool:
        """Deterministic head-based sampling decision for a trace id
        (pod uid): every component agrees on the same pods without
        shared state, so sampled traces are complete end-to-end. Runs
        once or twice per scheduled pod on the hot paths — one crc32
        over a short byte string, no allocation beyond the encode.

        ``inbound`` is an explicit decision propagated on the wire
        (``X-Ktpu-Trace``); when present it WINS over local crc32
        re-derivation both ways — a pod sampled at the ingesting
        client stays sampled in every process it touches even if
        seeds/rates disagree, and an unsampled one stays out. A
        disabled tracer still records nothing."""
        if not self.enabled:
            return False
        if inbound is not None:
            return bool(inbound)
        rate = self.sample_rate
        if rate >= 1.0:
            return True
        if rate <= 0.0:
            return False
        return (zlib.crc32(self._seed_prefix + uid.encode())
                & 0xFFFFFFFF) < self._sample_cut

    # -- recording -----------------------------------------------------
    def span(self, name: str, trace: str = "", **attrs) -> Span:
        """Open a nested span (context manager). Parent is the innermost
        open span on this thread."""
        parent = 0
        stack = getattr(self._local, "stack", None)
        if stack:
            top = stack[-1]
            parent = top.span_id
            if not trace:
                trace = top.trace
        return Span(self, name, trace, attrs or None,
                    next(self._ids), parent)

    def current_span_id(self) -> int:
        """The innermost open span's id on this thread (0 when none): what
        an outgoing request stamps as the wire parent."""
        stack = getattr(self._local, "stack", None)
        return stack[-1].span_id if stack else 0

    def annotate_current(self, **attrs) -> bool:
        """Attach attributes to the innermost open span on this thread;
        False when none is open."""
        stack = getattr(self._local, "stack", None)
        if not stack:
            return False
        stack[-1].set(**attrs)
        return True

    def _push(self, span: Span) -> None:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        stack.append(span)

    def _pop_and_record(self, span: Span) -> None:
        stack = getattr(self._local, "stack", None)
        if stack and stack[-1] is span:
            stack.pop()
        elif stack and span in stack:      # out-of-order exit
            stack.remove(span)
        if not self.enabled:
            return
        end = time.monotonic()
        self._append(span.name, _PH_SPAN, end, end - span.t0, span.trace,
                     span.span_id, span.parent_id, span.attrs)

    def record(self, name: str, start_mono: float,
               end_mono: Optional[float] = None, trace: str = "",
               parent_id: int = 0, **attrs) -> None:
        """Record a completed span from explicit monotonic timestamps —
        the cross-component path (e.g. a queue-wait span whose start was
        stamped at enqueue time by a different thread)."""
        if not self.enabled:
            return
        if end_mono is None:
            end_mono = time.monotonic()
        self._append(name, _PH_SPAN, end_mono, end_mono - start_mono,
                     trace, next(self._ids), parent_id, attrs or None)

    def event(self, name: str, trace: str = "",
              at_mono: Optional[float] = None, parent_id: int = 0,
              **attrs) -> None:
        """Record an instant event (a point in time, no duration).
        ``at_mono`` back-dates the event to an already-captured
        monotonic timestamp (e.g. a Trace step stamped earlier)."""
        if not self.enabled:
            return
        self._append(name, _PH_INSTANT,
                     time.monotonic() if at_mono is None else at_mono,
                     0.0, trace, next(self._ids), parent_id,
                     attrs or None)

    def _append(self, name: str, ph: str, end: float, dur: float,
                trace: str, span_id: int, parent_id: int,
                attrs: Optional[dict]) -> None:
        tid = threading.get_ident()
        if tid not in self._tids:
            self._tids[tid] = threading.current_thread().name
        # deque.append with maxlen is GIL-atomic: no tracer lock on the
        # hot path, eviction of the oldest record is free
        self._ring.append(
            (name, ph, end, dur, trace, span_id, parent_id, tid, attrs))
        if ph == _PH_SPAN and self._phase_hist is not None:
            try:
                self._phase_hist.observe(dur, name)
            except Exception:   # pragma: no cover — must never break paths
                pass

    def clear(self) -> None:
        self._ring.clear()

    def __len__(self) -> int:
        return len(self._ring)

    # -- derived stats -------------------------------------------------
    def phase_stats(self, window_s: Optional[float] = None
                    ) -> Dict[str, Dict[str, float]]:
        """Per-phase {count, total_s, p50_s, p99_s} computed from the
        ring's spans (EXACT percentiles, unlike the bucket-interpolated
        /metrics histogram). ``window_s`` bounds the lookback;
        default: everything still in the ring."""
        cut = None if window_s is None else time.monotonic() - window_s
        durs: Dict[str, List[float]] = {}
        for rec in list(self._ring):
            name, ph, end, dur = rec[0], rec[1], rec[2], rec[3]
            if ph != _PH_SPAN or (cut is not None and end < cut):
                continue
            durs.setdefault(name, []).append(dur)
        out: Dict[str, Dict[str, float]] = {}
        for name, vals in durs.items():
            vals.sort()
            n = len(vals)
            out[name] = {
                "count": n,
                "total_s": sum(vals),
                "p50_s": vals[n // 2] if n else 0.0,
                "p99_s": vals[min(n - 1, int(n * 0.99))] if n else 0.0,
            }
        return out

    # -- export --------------------------------------------------------
    def export_perfetto(self, window_s: Optional[float] = None) -> dict:
        """Chrome/Perfetto ``trace_event`` JSON for the trailing
        ``window_s`` (default: the recorder's retention window). Loads
        in https://ui.perfetto.dev as-is."""
        now = time.monotonic()
        cut = now - (self.retain_s if window_s is None else window_s)
        pid = os.getpid()
        events: List[dict] = [{
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "ts": 0, "args": {"name": self.component},
        }]
        tids_seen = set()
        for rec in list(self._ring):
            name, ph, end, dur, trace, span_id, parent_id, tid, attrs = rec
            if end < cut:
                continue
            ts_us = (end - dur - self._epoch_mono) * 1e6
            ev: Dict[str, Any] = {
                "name": name, "ph": ph, "ts": ts_us,
                "pid": pid, "tid": tid,
                "args": {"trace": trace, "id": span_id,
                         "parent": parent_id},
            }
            if attrs:
                ev["args"].update(attrs)
            if ph == _PH_SPAN:
                ev["dur"] = dur * 1e6
            else:
                ev["s"] = "t"
            events.append(ev)
            tids_seen.add(tid)
        for tid in tids_seen:
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "ts": 0, "args": {"name": self._tids.get(tid, str(tid))},
            })
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "component": self.component,
                "epoch_wall": self._epoch_wall,
                "epoch_mono": self._epoch_mono,
                "sample_rate": self.sample_rate,
                "seed": self.seed,
            },
        }

    def dump(self, path: Optional[str] = None, reason: str = "manual",
             window_s: Optional[float] = None,
             min_interval_s: float = 0.0) -> Optional[str]:
        """Write a flight-recorder dump to disk; returns the path (None
        on failure — dumping is best-effort by contract: it runs from
        degraded-mode entry and crash handlers). ``min_interval_s``
        rate-limits per reason AND reuses one stable filename for that
        reason: a chaos run flapping in and out of degraded mode must
        not serialize the ring on every flap nor fill the dump dir.
        The default directory is ``KTPU_TRACE_DUMP_DIR``, else the
        ``TMPDIR``."""
        # non-blocking: a concurrent dump already has the postmortem in
        # hand, and the SIGTERM handler runs on the main thread — if the
        # signal lands while this thread is mid-dump, a blocking acquire
        # of a lock the same thread holds would hang shutdown forever
        if not self._dump_lock.acquire(blocking=False):
            return self.last_dump_path
        try:
            stable = min_interval_s > 0.0
            now = time.monotonic()
            if stable:
                last = self._last_dump_mono.get(reason)
                if last is not None and now - last < min_interval_s:
                    return self._last_dump_paths.get(reason)
            if path is None:
                base = self._dump_dir or os.environ.get("TMPDIR", "/tmp")
                os.makedirs(base, exist_ok=True)
                # rate-limited auto-dumps reuse ONE file per reason: a
                # flapping trigger overwrites the last postmortem
                # instead of growing the dump dir without bound
                suffix = "" if stable else f"-{next(self._dump_seq)}"
                path = os.path.join(
                    base,
                    f"schedtrace-{self.component}-{os.getpid()}-"
                    f"{reason}{suffix}.json")
            doc = self.export_perfetto(window_s)
            doc["otherData"]["reason"] = reason
            with open(path, "w") as f:
                json.dump(doc, f)
            # rate-limit state only advances on SUCCESS: a failed
            # best-effort write must not suppress the retry window
            self._last_dump_mono[reason] = now
            self._last_dump_paths[reason] = path
            self.last_dump_path = path
            return path
        except Exception:   # noqa: BLE001 — best-effort by contract
            return None
        finally:
            self._dump_lock.release()

    # -- crash dumps (atexit + SIGTERM, best-effort) -------------------
    def arm_crash_dump(self, dump_dir: Optional[str] = None) -> None:
        """Dump the flight recorder on interpreter exit and on SIGTERM
        (best-effort: SIGKILL cannot be caught). Idempotent."""
        if dump_dir:
            self._dump_dir = dump_dir
        if self._crash_armed:
            return
        self._crash_armed = True
        import atexit

        def _on_exit() -> None:
            if self.enabled and len(self._ring):
                self.dump(reason="exit")

        atexit.register(_on_exit)
        try:
            import signal

            prev = signal.getsignal(signal.SIGTERM)

            def _on_term(signum, frame):
                if self.enabled and len(self._ring):
                    self.dump(reason="sigterm")
                if callable(prev):
                    prev(signum, frame)
                elif prev is signal.SIG_IGN:
                    # the process deliberately ignored SIGTERM; arming
                    # tracing must not change that into an exit
                    return
                else:
                    raise SystemExit(143)

            signal.signal(signal.SIGTERM, _on_term)
        except (ValueError, OSError):
            # not the main thread / embedded interpreter: atexit alone
            pass

    # -- runtime reconfiguration ---------------------------------------
    def configure(self, enabled: Optional[bool] = None,
                  sample_rate: Optional[float] = None,
                  seed: Optional[int] = None,
                  retain_s: Optional[float] = None) -> None:
        if enabled is not None:
            self.enabled = enabled
        if sample_rate is not None:
            self.sample_rate = float(sample_rate)
            self._sample_cut = int(self.sample_rate * _SAMPLE_DENOM)
        if seed is not None:
            self.seed = int(seed)
            self._seed_prefix = f"{self.seed}:".encode()
        if retain_s is not None:
            self.retain_s = float(retain_s)


def _env_sample_rate() -> float:
    """KTPU_TRACE_SAMPLE: a probability ("0.1") or a denominator
    ("64" = 1-in-64). Invalid values fall back to the default."""
    raw = os.environ.get("KTPU_TRACE_SAMPLE", "")
    if not raw:
        return DEFAULT_SAMPLE_RATE
    try:
        v = float(raw)
    except ValueError:
        return DEFAULT_SAMPLE_RATE
    if v > 1.0:
        return 1.0 / v
    return max(0.0, v)


def _phase_histogram(registry=None):
    """``schedtrace_phase_duration_seconds{phase=...}`` in the process
    registry — reused if already registered (multiple Tracer instances
    in one process share series, the fabric_metrics pattern)."""
    try:
        from kubernetes_tpu_torch.metrics import default_registry
        from kubernetes_tpu_torch.metrics.registry import Histogram

        reg = registry if registry is not None else default_registry()
        existing = reg.get("schedtrace_phase_duration_seconds")
        if isinstance(existing, Histogram):
            return existing
        return reg.register(Histogram(
            "schedtrace_phase_duration_seconds",
            "Span-derived latency breakdown per scheduling phase "
            "(REST ingest, queue wait, encode, device solve, commit, "
            "bind), recorded by the flight-recorder tracer",
            ("phase",),
        ))
    except Exception:   # pragma: no cover — tracing must not break startup
        return None


_default: Optional[Tracer] = None
_default_lock = threading.Lock()


def get_tracer() -> Tracer:
    """Process-wide tracer (the legacyregistry pattern). Disabled
    entirely with KTPU_TRACE=off."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                t = Tracer(
                    enabled=os.environ.get("KTPU_TRACE", "") != "off")
                if os.environ.get("KTPU_TRACE_DUMP_DIR"):
                    t.arm_crash_dump()
                _default = t
    return _default


def set_tracer(tracer: Tracer) -> Tracer:
    global _default
    _default = tracer
    return tracer
