"""Fleet trace federation + cross-process critical-path attribution.

The REST harness spawns real child processes (the apiserver, the
creators) and each keeps its own flight-recorder ring
(``observability/tracer.py``). This is the tracing sibling of
``metrics/federation.py``:

- ``TraceFederation.scrape`` pulls each process's ``/debug/trace``
  Perfetto dump.  The scrape request carries an ``echo_mono`` query
  parameter (this process's ``time.monotonic()`` at send); the server
  echoes it next to its own ``server_mono`` stamped at export, so the
  federation estimates the per-connection clock offset as
  ``server_mono - (t0 + rtt/2)`` — the classic half-RTT echo.  The
  correction is *bounded*: the true offset lies within ±rtt/2 of the
  estimate, and that bound is recorded as ``skew_ms`` on every
  imported span (the merged timeline is honest about how far two
  processes' spans may really be apart).
- ``merged()`` renders ONE Chrome/Perfetto document with a track per
  process (``pid`` = import order, ``process_name`` = instance), all
  timestamps skew-corrected onto the federation's own monotonic
  timeline and shifted so the earliest span starts at 0.
- ``critical_path()`` is a pure analysis pass over the merged
  document: it walks each sampled pod's stitched span set
  (rest.ingest → rest.{verb} → queue.wait → encode → solve → commit →
  bind, across process boundaries) plus the batch-level cycle spans
  that overlap the pod's in-flight window, and emits a per-pod critical
  path and a per-phase fleet aggregate — the ``critical_path``
  sub-object every harness row carries (phase shares,
  ``unattributed_share``, ``max_skew_ms``).
- ``absorb_local`` takes a tracer of this process, with no offset and
  no skew.

Everything here is best-effort by the same contract as metrics
federation: a dying child must not fail the row, so scrape failures
land in ``scrape_errors`` and the analysis runs on whatever was
imported.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Tuple

from kubernetes_tpu_torch.observability.tracer import Tracer

SEAM_PREFIX = "seam:"

# Phase classification for the critical-path sweep.  When two spans
# overlap the same instant of a pod's in-flight window, the LATER
# pipeline phase wins (a pod inside solve.commit is committing even if
# its queue.wait span — closed late by a different thread — still
# covers that instant).  Seam spans (reshard freeze, upgrade roll)
# rank above nothing but unattributed time: they explain a stall only
# where no scheduling phase already does.
PHASE_PRIORITY = ("bind", "commit", "solve", "encode", "queue",
                  "rest", "watch", "seam")
_PRIO = {p: i for i, p in enumerate(PHASE_PRIORITY)}


def phase_of(name: str) -> Optional[str]:
    """Span name → pipeline phase (None = not a pipeline span)."""
    if name.startswith("sched.bind") or name.startswith("bind"):
        return "bind"
    if name == "solve.commit":
        return "commit"
    if name in ("solve.encode", "solve.pack"):
        return "encode"
    if name.startswith("solve"):
        return "solve"
    if name.startswith("queue"):
        return "queue"
    if name.startswith("rest") or name.startswith("route"):
        return "rest"
    if name.startswith("watch"):
        return "watch"
    if (name.startswith("reshard") or name.startswith("upgrade")
            or name.startswith("fed") or name.startswith("seam")):
        return "seam"
    return None


class TraceFederation:
    """Scrapes per-process ``/debug/trace`` dumps and maintains the
    skew-corrected merged fleet timeline (see module docstring)."""

    def __init__(self):
        # instance -> list of normalized records; a record is
        # {name, ph, t0 (abs local-monotonic, corrected), dur_s,
        #  trace, id, parent, tid, attrs, skew_ms}
        self._spans: Dict[str, List[dict]] = {}
        self._threads: Dict[str, Dict[int, str]] = {}
        self._offsets: Dict[str, float] = {}
        self._skew_ms: Dict[str, float] = {}
        self._meta: Dict[str, dict] = {}
        self.scrape_errors: List[str] = []

    # -- ingestion -----------------------------------------------------
    def scrape(self, url: str, instance: str, token: str = "",
               timeout: float = 10.0,
               window_s: Optional[float] = None) -> bool:
        """HTTP GET a component's ``/debug/trace`` and absorb it with
        half-RTT clock-offset correction. ``url`` is the server base
        (``http://host:port``). Best-effort: failures land in
        ``scrape_errors`` and return False."""
        import http.client
        import json as _json

        rest = url.split("://", 1)[-1]
        hostport = rest.split("/", 1)[0]
        host, _, port = hostport.partition(":")
        t0 = time.monotonic()
        path = f"/debug/trace?echo_mono={t0!r}"
        if window_s is not None:
            path += f"&window={float(window_s)!r}"
        try:
            conn = http.client.HTTPConnection(
                host, int(port or 80), timeout=timeout)
            try:
                headers = {"Authorization": f"Bearer {token}"} \
                    if token else {}
                conn.request("GET", path, headers=headers)
                resp = conn.getresponse()
                body = resp.read()
                t1 = time.monotonic()
                if resp.status != 200:
                    raise RuntimeError(f"HTTP {resp.status} from {url}")
                doc = _json.loads(body)
            finally:
                conn.close()
        except Exception as e:  # noqa: BLE001 — scraping is best-effort
            self.scrape_errors.append(f"{instance} {url}: {e}")
            return False
        other = doc.get("otherData", {})
        server_mono = other.get("server_mono")
        rtt = max(0.0, t1 - t0)
        if server_mono is None:
            # a server that does not echo: import uncorrected with an
            # honest worst-case skew bound of the full RTT
            offset, skew_ms = 0.0, rtt * 1000.0
        else:
            # the server stamped server_mono somewhere inside [t0, t1];
            # midpoint estimate, true offset within ±rtt/2
            offset = float(server_mono) - (t0 + rtt / 2.0)
            skew_ms = (rtt / 2.0) * 1000.0
        self.absorb_doc(doc, instance, offset=offset, skew_ms=skew_ms)
        return True

    def absorb_local(self, tracer: Tracer, instance: str,
                     window_s: Optional[float] = None) -> None:
        """Mirror a LOCAL tracer into the federation (the parent
        process is a component too) — zero offset, zero skew: its
        monotonic clock IS the federation's reference timeline."""
        self.absorb_doc(tracer.export_perfetto(window_s), instance,
                        offset=0.0, skew_ms=0.0)

    def absorb_doc(self, doc: dict, instance: str, offset: float = 0.0,
                   skew_ms: float = 0.0) -> None:
        """Normalize one process's Perfetto dump onto the federation
        timeline: event ``ts`` is relative to the source's
        ``epoch_mono``; corrected absolute time = ts + epoch_mono −
        offset. The skew bound is recorded on every imported span."""
        other = doc.get("otherData", {})
        epoch_mono = float(other.get("epoch_mono", 0.0))
        self._offsets[instance] = offset
        self._skew_ms[instance] = skew_ms
        self._meta[instance] = {
            "component": other.get("component", instance),
            "epoch_wall": other.get("epoch_wall"),
            "sample_rate": other.get("sample_rate"),
            "seed": other.get("seed"),
        }
        spans = self._spans[instance] = []
        threads = self._threads.setdefault(instance, {})
        for ev in doc.get("traceEvents", []):
            ph = ev.get("ph")
            if ph == "M":
                if ev.get("name") == "thread_name":
                    threads[ev.get("tid", 0)] = \
                        ev.get("args", {}).get("name", "")
                continue
            if ph not in ("X", "i"):
                continue
            args = dict(ev.get("args") or {})
            t0 = ev.get("ts", 0.0) / 1e6 + epoch_mono - offset
            spans.append({
                "name": ev.get("name", ""), "ph": ph, "t0": t0,
                "dur_s": ev.get("dur", 0.0) / 1e6,
                "trace": args.pop("trace", ""),
                "id": args.pop("id", 0),
                "parent": args.pop("parent", 0),
                "tid": ev.get("tid", 0),
                "attrs": args or None,
                "skew_ms": skew_ms,
            })

    def forget_instance(self, instance: str) -> None:
        for table in (self._spans, self._threads, self._offsets,
                      self._skew_ms, self._meta):
            table.pop(instance, None)

    def clear(self) -> None:
        for table in (self._spans, self._threads, self._offsets,
                      self._skew_ms, self._meta):
            table.clear()
        self.scrape_errors = []

    def instances(self) -> List[str]:
        return list(self._spans)

    # -- export --------------------------------------------------------
    def merged(self) -> dict:
        """One fleet Perfetto document: a track per process (pid =
        import order), skew-corrected timestamps shifted so the
        earliest record starts at 0, ``instance`` + ``skew_ms`` on
        every span."""
        base = None
        for spans in self._spans.values():
            for rec in spans:
                if base is None or rec["t0"] < base:
                    base = rec["t0"]
        base = base or 0.0
        events: List[dict] = []
        for pid, (instance, spans) in enumerate(
                sorted(self._spans.items()), start=1):
            events.append({
                "ph": "M", "name": "process_name", "pid": pid,
                "tid": 0, "ts": 0,
                "args": {"name": instance},
            })
            for tid, tname in self._threads.get(instance, {}).items():
                events.append({
                    "ph": "M", "name": "thread_name", "pid": pid,
                    "tid": tid, "ts": 0, "args": {"name": tname},
                })
            for rec in spans:
                ev = {
                    "name": rec["name"], "ph": rec["ph"],
                    "ts": (rec["t0"] - base) * 1e6,
                    "pid": pid, "tid": rec["tid"],
                    "args": {"trace": rec["trace"], "id": rec["id"],
                             "parent": rec["parent"],
                             "instance": instance,
                             "skew_ms": round(rec["skew_ms"], 3)},
                }
                if rec["attrs"]:
                    ev["args"].update(rec["attrs"])
                if rec["ph"] == "X":
                    ev["dur"] = rec["dur_s"] * 1e6
                else:
                    ev["s"] = "t"
                events.append(ev)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "fleet": True,
                "instances": {
                    inst: {
                        "offset_s": round(self._offsets.get(inst, 0.0),
                                          6),
                        "skew_ms": round(self._skew_ms.get(inst, 0.0),
                                         3),
                        **self._meta.get(inst, {}),
                    }
                    for inst in self._spans
                },
                "scrape_errors": list(self.scrape_errors),
            },
        }


# -- critical-path attribution (pure analysis) -------------------------

def _sweep(intervals: List[Tuple[float, float, str]],
           lo: float, hi: float) -> Tuple[Dict[str, float], float]:
    """Priority interval sweep over [lo, hi]: for every elementary
    segment, the highest-priority covering phase owns it. Returns
    ({phase: seconds}, attributed seconds)."""
    points = {lo, hi}
    for s, e, _p in intervals:
        if e > lo and s < hi:
            points.add(max(s, lo))
            points.add(min(e, hi))
    cuts = sorted(points)
    shares: Dict[str, float] = {}
    attributed = 0.0
    for a, b in zip(cuts, cuts[1:]):
        if b <= a:
            continue
        mid = (a + b) / 2.0
        best = None
        for s, e, p in intervals:
            if s <= mid < e and (best is None
                                 or _PRIO[p] < _PRIO[best]):
                best = p
        if best is not None:
            shares[best] = shares.get(best, 0.0) + (b - a)
            attributed += b - a
    return shares, attributed


def critical_path(doc: dict, skew_bound_ms: float = 50.0,
                  max_pods: int = 0) -> dict:
    """Walk each sampled pod's stitched span set in a merged fleet
    document and attribute its arrival→bind window to pipeline phases.

    Per pod: the window is [earliest own record, latest own record];
    candidate intervals are the pod's own spans PLUS batch-level cycle
    spans (encode/solve/commit/bind.bulk plus the covering
    ``queue.cycle`` drain→commit span, none of which carry a pod
    trace) and ``seam:<epoch>`` spans overlapping the window; the
    priority
    sweep (later pipeline phase wins) yields per-phase seconds and the
    unattributed remainder.

    Returns the fleet aggregate a harness row carries: phase shares
    over the summed pod windows, ``top``/``top_share``,
    ``unattributed_share``, ``max_skew_ms``, ``fully_attributed``
    (fraction of pods with own unattributed_share ≤ 0.05), and per-pod
    paths (bounded by ``max_pods``; 0 = all)."""
    by_pod: Dict[str, List[dict]] = {}
    cycle: List[Tuple[float, float, str]] = []
    seams: List[Tuple[float, float, str]] = []
    max_skew = 0.0
    for ev in doc.get("traceEvents", []):
        ph = ev.get("ph")
        if ph not in ("X", "i"):
            continue
        args = ev.get("args") or {}
        max_skew = max(max_skew, float(args.get("skew_ms", 0.0)))
        trace = args.get("trace", "") or ""
        t0 = ev.get("ts", 0.0) / 1e6
        t1 = t0 + ev.get("dur", 0.0) / 1e6
        if trace.startswith(SEAM_PREFIX):
            if ph == "X":
                seams.append((t0, t1, "seam"))
            continue
        if trace:
            by_pod.setdefault(trace, []).append(
                {"name": ev.get("name", ""), "ph": ph,
                 "t0": t0, "t1": t1,
                 "instance": args.get("instance", "")})
        elif ph == "X":
            p = phase_of(ev.get("name", ""))
            if p in ("encode", "solve", "commit", "bind", "queue"):
                cycle.append((t0, t1, p))
    pods: List[dict] = []
    agg: Dict[str, float] = {}
    total_window = 0.0
    total_attr = 0.0
    fully = 0
    for uid, recs in sorted(by_pod.items()):
        lo = min(r["t0"] for r in recs)
        hi = max(r["t1"] for r in recs)
        if hi <= lo:
            continue
        intervals: List[Tuple[float, float, str]] = []
        for r in recs:
            if r["ph"] != "X":
                continue
            p = phase_of(r["name"])
            if p is not None and r["t1"] > r["t0"]:
                intervals.append((r["t0"], r["t1"], p))
        intervals.extend(i for i in cycle if i[1] > lo and i[0] < hi)
        intervals.extend(i for i in seams if i[1] > lo and i[0] < hi)
        shares, attributed = _sweep(intervals, lo, hi)
        window = hi - lo
        unatt = max(0.0, 1.0 - attributed / window)
        if unatt <= 0.05:
            fully += 1
        total_window += window
        total_attr += attributed
        for p, s in shares.items():
            agg[p] = agg.get(p, 0.0) + s
        top = max(shares, key=shares.get) if shares else ""
        pods.append({
            "trace": uid,
            "window_ms": round(window * 1000.0, 3),
            "top": top,
            "phases_ms": {p: round(s * 1000.0, 3)
                          for p, s in sorted(shares.items())},
            "unattributed_share": round(unatt, 4),
            "instances": sorted({r["instance"] for r in recs
                                 if r["instance"]}),
        })
    n = len(pods)
    phase_shares = {p: round(s / total_window, 4)
                    for p, s in sorted(agg.items())} \
        if total_window > 0 else {}
    top = max(phase_shares, key=phase_shares.get) if phase_shares \
        else ""
    out = {
        "pods": n,
        "fully_attributed": round(fully / n, 4) if n else 0.0,
        "phase_shares": phase_shares,
        "top": top,
        "top_share": phase_shares.get(top, 0.0),
        "unattributed_share": round(
            1.0 - total_attr / total_window, 4)
        if total_window > 0 else 1.0,
        "max_skew_ms": round(max_skew, 3),
        "skew_bound_ms": skew_bound_ms,
        "seam_windows": len(seams),
    }
    out["per_pod"] = pods if not max_pods else pods[:max_pods]
    return out


def collect_fleet_trace(
        remote: Iterable[Tuple[str, str]] = (),
        local: Iterable[Tuple[str, Tracer]] = (),
        token: str = "",
        window_s: Optional[float] = None,
        max_pods: int = 0) -> Tuple[dict, dict]:
    """One-call harness entry point: scrape ``(instance, url)`` pairs,
    absorb ``(instance, tracer)`` locals, return (merged fleet doc,
    critical-path aggregate). Best-effort end to end — scrape failures
    are listed in the doc's ``otherData.scrape_errors``."""
    fed = TraceFederation()
    for instance, url in remote:
        fed.scrape(url, instance, token=token, window_s=window_s)
    for instance, tracer in local:
        fed.absorb_local(tracer, instance, window_s=window_s)
    doc = fed.merged()
    return doc, critical_path(doc, max_pods=max_pods)
