"""Live SLO evaluation with multi-window burn-rate alerting.

An SLO is an objective over an SLI as a good-event ratio ("99% of pods
schedule in 1 s or less"). Latency SLOs count histogram observations
above the threshold bucket as bad; error-ratio SLOs read a bad/good
counter pair. The engine samples the backing series on each ``tick`` and
evaluates every SLO over a rolling fast and slow window. The burn rate
is the bad fraction over the allowed fraction; an alert fires only when
both windows burn hot (fast at least 14.4 times the budget and slow at
least 6 times, the Google SRE workbook's page), and then the flight
recorder dumps (``tracer.dump(reason="slo-<name>")``, rate-limited). The
verdicts are mirrored into ``slo_burn_rate{slo,window}``,
``slo_violated{slo}`` and ``slo_alerts_total{slo}``.

The engine reads the process registry and every registry attached with
``add_registry`` (a scheduler's own holds the e2e latency histogram).
The default SLOs are the JAX package's; ``rest_availability`` reads the
API Priority and Fairness counters, which the apiserver's flow control
(``apiserver/flowcontrol.py``) keeps, in its own process or folded into
this one by the metrics federation.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# Google SRE workbook multi-window page thresholds (5m/1h), reused at
# whatever window pair the engine is configured with
DEFAULT_FAST_BURN = 14.4
DEFAULT_SLOW_BURN = 6.0
DEFAULT_FAST_WINDOW_S = 300.0
DEFAULT_SLOW_WINDOW_S = 3600.0


@dataclass
class SLODef:
    """One objective over one SLI.

    ``kind="latency"``: ``metric`` names a histogram; good events are
    observations ≤ ``threshold_s`` (evaluated at the first bucket edge
    ≥ the threshold, so pick thresholds on bucket edges). ``labels``
    selects one series; None aggregates every series of the metric.

    ``kind="error_ratio"``: ``metric`` names the BAD-event counter,
    ``total_metric`` the good-event counter; total = good + bad.
    """

    name: str
    description: str
    metric: str
    kind: str = "latency"               # "latency" | "error_ratio"
    threshold_s: float = 1.0
    objective: float = 0.99             # required good-event fraction
    labels: Optional[Tuple[str, ...]] = None
    total_metric: str = ""


def default_slos() -> List[SLODef]:
    """The cluster's standing objectives. Thresholds sit on bucket
    edges of their backing histograms."""
    return [
        SLODef(
            name="schedule_latency",
            description="99% of pods schedule (e2e, algorithm+binding) "
                        "within 1s",
            metric="scheduler_e2e_scheduling_duration_seconds",
            labels=("scheduled",),
            threshold_s=1.0, objective=0.99,
        ),
        SLODef(
            name="watch_delivery",
            description="99% of watch events reach client decode "
                        "within 500ms of store commit",
            metric="watch_delivery_seconds",
            threshold_s=0.5, objective=0.99,
        ),
        SLODef(
            name="snapshot_staleness",
            description="99% of solve cycles run against a snapshot "
                        "no older than 2s",
            metric="snapshot_staleness_seconds",
            threshold_s=2.0, objective=0.99,
        ),
        SLODef(
            name="rest_availability",
            description="99.9% of admitted API requests are not "
                        "rejected with 429/503 by flow control",
            metric="apf_rejected_requests_total",
            kind="error_ratio",
            total_metric="apf_dispatched_requests_total",
            objective=0.999,
        ),
    ]


@dataclass
class _Sample:
    t: float
    bad: float
    total: float
    # latency SLOs also carry the aggregated bucket vector + edges so
    # windowed quantiles come from bucket DELTAS, not lifetime counts
    counts: Optional[List[int]] = None
    edges: Optional[Tuple[float, ...]] = None


@dataclass
class _SLOState:
    slo: SLODef
    samples: List[_Sample] = field(default_factory=list)
    alerting: bool = False


def _quantile_from_counts(counts: List[int], edges: Tuple[float, ...],
                          q: float) -> float:
    """Bucket-interpolated quantile over a windowed delta vector — the
    shared ``registry.quantile_from_counts`` math."""
    from kubernetes_tpu_torch.metrics.registry import quantile_from_counts

    return quantile_from_counts(counts, edges, q)


class SLOEngine:
    """Samples SLI series on a tick, evaluates rolling-window burn
    rates, alerts on the multi-window condition. One per process via
    ``get_slo_engine()``; harnesses ``reset()`` it per row with
    the row scheduler's registry attached and row-scaled windows."""

    def __init__(
        self,
        slos: Optional[List[SLODef]] = None,
        registries: Optional[list] = None,
        fast_window_s: float = DEFAULT_FAST_WINDOW_S,
        slow_window_s: float = DEFAULT_SLOW_WINDOW_S,
        fast_burn: float = DEFAULT_FAST_BURN,
        slow_burn: float = DEFAULT_SLOW_BURN,
        enabled: bool = True,
        clock=time.monotonic,
    ):
        self.enabled = enabled
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self._clock = clock
        self._lock = threading.Lock()
        self._extra_registries: list = list(registries or [])
        self._states: Dict[str, _SLOState] = {}
        for slo in (slos if slos is not None else default_slos()):
            self._states[slo.name] = _SLOState(slo)
        self._gauges = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- wiring --------------------------------------------------------
    def _registries(self) -> list:
        from kubernetes_tpu_torch.metrics import default_registry

        return [default_registry()] + list(self._extra_registries)

    def add_registry(self, registry) -> None:
        """Attach another registry to search for SLI series (e.g. a
        Scheduler's own — the e2e latency histogram lives there).
        Newest attach wins: ``_find_metric`` returns the FIRST match,
        and a process that runs schedulers sequentially (chaos/elastic
        harnesses attach one per scenario without a reset between)
        must read the live scheduler's series, not a dead
        predecessor's frozen histogram."""
        with self._lock:
            if registry in self._extra_registries:
                self._extra_registries.remove(registry)
            self._extra_registries.insert(0, registry)

    def reset(self, extra_registries: Optional[list] = None,
              fast_window_s: Optional[float] = None,
              slow_window_s: Optional[float] = None,
              slos: Optional[List[SLODef]] = None) -> None:
        """Fresh evaluation window (per row): drops every sample
        and alert latch, replaces the attached registries, optionally
        rescales the windows to a row.s timescale or swaps the SLO set."""
        with self._lock:
            if extra_registries is not None:
                self._extra_registries = list(extra_registries)
            if fast_window_s is not None:
                self.fast_window_s = float(fast_window_s)
            if slow_window_s is not None:
                self.slow_window_s = float(slow_window_s)
            if slos is not None:
                self._states = {s.name: _SLOState(s) for s in slos}
            else:
                for st in self._states.values():
                    st.samples = []
                    st.alerting = False

    def configure(self, enabled: Optional[bool] = None) -> None:
        if enabled is not None:
            self.enabled = enabled

    # -- sampling ------------------------------------------------------
    def _find_metric(self, name: str):
        for reg in self._registries():
            m = reg.get(name)
            if m is not None:
                return m
        return None

    def _snapshot(self, slo: SLODef) -> Optional[_Sample]:
        from kubernetes_tpu_torch.metrics.registry import Histogram

        now = self._clock()
        if slo.kind == "error_ratio":
            bad_m = self._find_metric(slo.metric)
            total_m = self._find_metric(slo.total_metric)
            bad = sum(v for _n, _k, v in bad_m.collect()) \
                if bad_m is not None else 0.0
            good = sum(v for _n, _k, v in total_m.collect()) \
                if total_m is not None else 0.0
            return _Sample(now, bad, bad + good)
        m = self._find_metric(slo.metric)
        if not isinstance(m, Histogram):
            return _Sample(now, 0.0, 0.0)
        edges = tuple(float(b) for b in m.buckets)
        agg = [0] * (len(edges) + 1)
        for labels, counts, _sum, _count in m.collect_full():
            if slo.labels is not None and tuple(labels) != slo.labels:
                continue
            for i, c in enumerate(counts):
                agg[i] += c
        total = sum(agg)
        # good = observations in buckets whose upper edge ≤ threshold
        good = 0
        for i, edge in enumerate(edges):
            if edge <= slo.threshold_s:
                good += agg[i]
            else:
                break
        return _Sample(now, float(total - good), float(total),
                       counts=agg, edges=edges)

    def tick(self, now: Optional[float] = None) -> None:
        """Sample every SLO's backing series. Cheap (a few collect()s);
        driven by the background thread or called directly by tests
        with an injected clock."""
        if not self.enabled:
            return
        with self._lock:
            states = list(self._states.values())
        for st in states:
            sample = self._snapshot(st.slo)
            if sample is None:
                continue
            if now is not None:
                sample.t = now
            with self._lock:
                st.samples.append(sample)
                # prune beyond the slow window (keep one anchor before
                # the window edge so deltas always have a base)
                cut = sample.t - self.slow_window_s
                keep = 0
                for i, s in enumerate(st.samples):
                    if s.t >= cut:
                        keep = max(0, i - 1)
                        break
                else:
                    keep = max(0, len(st.samples) - 2)
                if keep:
                    st.samples = st.samples[keep:]

    # -- evaluation ----------------------------------------------------
    def _window_delta(self, st: _SLOState, window_s: float,
                      now: float):
        """(Δbad, Δtotal, Δcounts) between now and the newest sample at
        or before the window start (earliest available as fallback)."""
        samples = st.samples
        if not samples:
            return 0.0, 0.0, None
        end = samples[-1]
        start = samples[0]
        cut = now - window_s
        for s in samples:
            if s.t <= cut:
                start = s
            else:
                break
        d_bad = max(0.0, end.bad - start.bad)
        d_total = max(0.0, end.total - start.total)
        d_counts = None
        if end.counts is not None and start.counts is not None \
                and len(end.counts) == len(start.counts):
            d_counts = [max(0, e - s) for e, s in
                        zip(end.counts, start.counts)]
        elif end.counts is not None:
            d_counts = list(end.counts)
        return d_bad, d_total, d_counts

    def evaluate(self, now: Optional[float] = None,
                 tick: bool = True) -> dict:
        """Evaluate every SLO over the fast and slow windows. Fires
        flight-recorder dumps on NEW multi-window burn alerts and
        mirrors verdicts into the slo_* metrics."""
        if not self.enabled:
            return {"enabled": False, "slos": {}}
        if tick:
            self.tick(now=now)
        if now is None:
            now = self._clock()
        out: Dict[str, dict] = {}
        healthy = True
        for st in list(self._states.values()):
            slo = st.slo
            allowed = max(1e-9, 1.0 - slo.objective)
            bad_f, total_f, counts_f = self._window_delta(
                st, self.fast_window_s, now)
            bad_s, total_s, _ = self._window_delta(
                st, self.slow_window_s, now)
            frac_f = bad_f / total_f if total_f > 0 else 0.0
            frac_s = bad_s / total_s if total_s > 0 else 0.0
            burn_f = frac_f / allowed
            burn_s = frac_s / allowed
            violated = total_f > 0 and burn_f >= 1.0
            alerting = (total_f > 0 and burn_f >= self.fast_burn
                        and burn_s >= self.slow_burn)
            status = {
                "description": slo.description,
                "kind": slo.kind,
                "objective": slo.objective,
                "window_fast_s": self.fast_window_s,
                "window_slow_s": self.slow_window_s,
                "events_fast": total_f,
                "bad_fast": bad_f,
                "burn_fast": round(burn_f, 3),
                "burn_slow": round(burn_s, 3),
                "violated": violated,
                "alerting": alerting,
                # budget left in the slow window at the current spend
                "budget_remaining_pct": round(
                    max(0.0, 1.0 - frac_s / allowed) * 100.0, 2),
            }
            if slo.kind == "latency":
                status["threshold_s"] = slo.threshold_s
                if counts_f and st.samples and \
                        st.samples[-1].edges is not None:
                    status["sli_fast_p99_s"] = round(
                        _quantile_from_counts(
                            counts_f, st.samples[-1].edges, 0.99), 4)
            healthy = healthy and not violated
            # read-modify the alert latch under the lock: the tick
            # thread and a concurrent evaluation must not
            # both observe "not yet alerting" and double-fire the
            # breach counter + dump
            with self._lock:
                newly_alerting = alerting and not st.alerting
                st.alerting = alerting
            out[slo.name] = status
            self._mirror(slo.name, status)
            if newly_alerting:
                self._on_breach(slo.name, status)
        return {"enabled": True, "healthy": healthy, "slos": out}

    # -- side effects --------------------------------------------------
    def _metrics(self):
        if self._gauges is None:
            from kubernetes_tpu_torch.metrics import default_registry
            from kubernetes_tpu_torch.metrics.registry import (
                counter as _counter,
                gauge as _gauge,
            )

            reg = default_registry()
            self._gauges = {
                "burn": _gauge(
                    reg, "slo_burn_rate",
                    "Error-budget burn rate per SLO and window (1.0 = "
                    "budget spent exactly at sustainable speed)",
                    ("slo", "window")),
                "violated": _gauge(
                    reg, "slo_violated",
                    "1 while the SLO's fast-window SLI breaches its "
                    "objective", ("slo",)),
                "alerts": _counter(
                    reg, "slo_alerts_total",
                    "Multi-window burn-rate alerts fired, per SLO",
                    ("slo",)),
            }
        return self._gauges

    def _mirror(self, name: str, status: dict) -> None:
        try:
            g = self._metrics()
            g["burn"].set(status["burn_fast"], name, "fast")
            g["burn"].set(status["burn_slow"], name, "slow")
            g["violated"].set(1.0 if status["violated"] else 0.0, name)
        except Exception:  # noqa: BLE001 — mirroring must never break
            pass

    def _on_breach(self, name: str, status: dict) -> None:
        """A burn-rate alert just latched: counter and flight-recorder
        dump (stable filename, rate-limited)."""
        try:
            self._metrics()["alerts"].inc(name)
        except Exception:  # noqa: BLE001
            pass
        try:
            from kubernetes_tpu_torch.observability.tracer import get_tracer

            tracer = get_tracer()
            if tracer.enabled:
                tracer.event("slo.burn_alert", slo=name,
                             burn_fast=status["burn_fast"],
                             burn_slow=status["burn_slow"])
                tracer.dump(reason=f"slo-{name}", min_interval_s=5.0)
        except Exception:  # noqa: BLE001 — dumping is best-effort
            pass

    # -- the live tick -------------------------------------------------
    def start(self, interval_s: float = 1.0) -> None:
        """Evaluate every ``interval_s`` on a daemon thread until
        ``stop`` (a second start while it runs does nothing)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def run() -> None:
            while not self._stop.wait(interval_s):
                try:
                    self.evaluate()
                except Exception:  # noqa: BLE001 — the loop must survive
                    pass

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="slo-engine")
        self._thread.start()

    def stop(self) -> None:
        """Stop the tick thread and join it."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None


_default: Optional[SLOEngine] = None
_default_lock = threading.Lock()


def get_slo_engine() -> SLOEngine:
    """Process-wide SLO engine (the legacyregistry pattern)."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = SLOEngine()
    return _default


def set_slo_engine(engine: SLOEngine) -> SLOEngine:
    global _default
    _default = engine
    return engine
