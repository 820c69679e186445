"""Freshness SLIs: how old the cluster state is that the scheduler acts
on.

- ``watch_delivery_seconds{kind}``: store commit to delivery. The port's
  store delivers watch batches synchronously in the committing call, so
  no series is observed here; the series exists so the SLO engine and
  the row summary read the same names as the JAX package's.
- ``snapshot_staleness_seconds``: per solve cycle, the age of the newest
  cache event reflected in the planes the solve ran against (the session
  notes it, the device profiler keeps it on the cycle record).

``KTPU_FRESHNESS=off`` (or ``configure(enabled=False)``) stops the
observations. The JAX package's informer and read-tier series have no
counterpart here: the port has no informers and no read tier."""

from __future__ import annotations

import os
from typing import Optional

from kubernetes_tpu_torch.metrics.registry import (
    MetricsRegistry,
    histogram,
    quantile_from_counts,
)

_DELIVERY_BUCKETS = (0.001, 0.002, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                     0.5, 1.0, 2.5, 5.0, 10.0)
_STALENESS_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                      2.0, 5.0, 10.0, 30.0)


class FreshnessMetrics:
    def __init__(self, registry: Optional[MetricsRegistry] = None):
        if registry is None:
            from kubernetes_tpu_torch.metrics import default_registry

            registry = default_registry()
        self.registry = registry
        self.enabled = os.environ.get("KTPU_FRESHNESS", "") != "off"
        self.watch_delivery_seconds = histogram(
            registry, "watch_delivery_seconds",
            "Watch-event propagation latency, store commit to client "
            "decode, by kind", ("kind",), buckets=_DELIVERY_BUCKETS)
        self.snapshot_staleness_seconds = histogram(
            registry, "snapshot_staleness_seconds",
            "Per solve cycle: age of the newest cache event reflected in "
            "the encoded planes the solve ran against",
            buckets=_STALENESS_BUCKETS)

    def configure(self, enabled: Optional[bool] = None) -> None:
        if enabled is not None:
            self.enabled = enabled

    def reset_window(self) -> None:
        """A fresh window for one harness row."""
        self.watch_delivery_seconds.clear()
        self.snapshot_staleness_seconds.clear()


_default: Optional[FreshnessMetrics] = None


def freshness_metrics() -> FreshnessMetrics:
    """The process-wide FreshnessMetrics on the default registry."""
    global _default
    if _default is None:
        _default = FreshnessMetrics()
    return _default


def freshness_row_summary(devprof_summary: Optional[dict] = None,
                          slo_statuses: Optional[dict] = None) -> dict:
    """A row's ``freshness`` sub-object: watch delivery p99 (over the
    bucket counts summed across kinds), the snapshot-staleness p99, the
    largest staleness a measured cycle saw, and the SLO verdicts."""
    fm = freshness_metrics()
    out: dict = {}
    wd = fm.watch_delivery_seconds
    per_kind = {}
    events = 0
    agg = [0] * (len(wd.buckets) + 1)
    for labels, counts, _sum, count in wd.collect_full():
        if not count:
            continue
        kind = labels[0] if labels else ""
        per_kind[kind] = round(
            quantile_from_counts(counts, wd.buckets, 0.99) * 1000, 2)
        for i, c in enumerate(counts):
            agg[i] += c
        events += count
    if events:
        out["watch_delivery_p99_ms"] = round(
            quantile_from_counts(agg, wd.buckets, 0.99) * 1000, 2)
        out["watch_delivery_events"] = events
        out["watch_delivery_p99_ms_by_kind"] = per_kind
    ss = fm.snapshot_staleness_seconds
    if ss.count():
        out["snapshot_staleness_p99_ms"] = round(ss.quantile(0.99) * 1000, 2)
    if devprof_summary and devprof_summary.get("max_staleness_s") \
            is not None:
        out["max_snapshot_staleness_ms"] = round(
            devprof_summary["max_staleness_s"] * 1000, 2)
    if slo_statuses:
        out["slo"] = {
            name: ("violated" if s.get("violated") else "ok")
            for name, s in sorted(slo_statuses.items())
            if s.get("events_fast") or s.get("violated")
        }
    return out
