"""REST-fabric resilience metrics: the observability half of the
fault-injection / degraded-mode stack (reference analogs:
``rest_client_requests_total`` retry labels in component-base,
apiserver's ``apiserver_request_terminations_total``, and the
chaosmonkey suites' per-disruption accounting).

Three series matter operationally:

- ``client_retries_total{verb,reason}`` — every time a client re-issued
  a request after a transport drop, a 429/503 pushback, or a watch
  relist; a climbing rate under steady state means the fabric is sick.
- ``faults_injected_total{fault,resource}`` — counted by the server's
  FaultGate at injection time, so a chaos run can reconcile "faults
  thrown" against "retries absorbed".
- ``degraded_mode_seconds`` — cumulative wall-clock the scheduler spent
  with binding paused because its client's circuit breaker was open
  (plus a 0/1 ``degraded_mode`` gauge for live dashboards).

The node-churn resilience layer adds three:
``node_evictions_total{reason}`` (pods deleted off unreachable or
vanished nodes), ``stale_binds_rejected_total{path}`` (commit-time
guards refusing an assignment whose target node died, was cordoned, or
went unreachable between solve and commit), and ``pod_rescue_seconds``
(eviction → replacement-bound latency through the rescue pipeline).
"""

from __future__ import annotations

from typing import Optional

from kubernetes_tpu_torch.metrics.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)


def _counter(registry: MetricsRegistry, name: str, help_text: str,
             labels=()) -> Counter:
    existing = registry.get(name)
    if isinstance(existing, Counter):
        return existing
    return registry.register(Counter(name, help_text, labels))


def _gauge(registry: MetricsRegistry, name: str, help_text: str,
           labels=()) -> Gauge:
    existing = registry.get(name)
    if isinstance(existing, Gauge):
        return existing
    return registry.register(Gauge(name, help_text, labels))


def _histogram(registry: MetricsRegistry, name: str, help_text: str,
               labels=(), buckets=None) -> Histogram:
    existing = registry.get(name)
    if isinstance(existing, Histogram):
        return existing
    if buckets is None:
        return registry.register(Histogram(name, help_text, labels))
    return registry.register(
        Histogram(name, help_text, labels, buckets=buckets))


class FabricMetrics:
    """Retry / fault / degraded-mode counters. Reuses already-registered
    metrics so the server's gate and any number of clients in one
    process share series instead of clobbering each other."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        if registry is None:
            from kubernetes_tpu_torch.metrics import default_registry

            registry = default_registry()
        self.registry = registry
        self.client_retries_total = _counter(
            registry, "client_retries_total",
            "Requests re-issued by REST clients, by verb and reason "
            "(transport, http_429, http_503, relist)",
            ("verb", "reason"),
        )
        self.faults_injected_total = _counter(
            registry, "faults_injected_total",
            "Wire faults injected by the apiserver FaultGate, by fault "
            "type and resource",
            ("fault", "resource"),
        )
        self.degraded_mode_seconds = _counter(
            registry, "degraded_mode_seconds",
            "Cumulative seconds the scheduler spent in degraded mode "
            "(binding paused, circuit breaker open)",
        )
        self.degraded_mode = _gauge(
            registry, "degraded_mode",
            "1 while the scheduler's client circuit breaker is open",
        )
        self.client_relists_total = _counter(
            registry, "client_relists_total",
            "Full relists performed by watch clients after a dropped "
            "stream or an expired resourceVersion",
            ("kind",),
        )
        # -- node-churn resilience --------------------------------------
        self.node_evictions_total = _counter(
            registry, "node_evictions_total",
            "Pods evicted off dead nodes, by reason (unreachable = "
            "nodelifecycle grace expiry, orphaned = pod bound to a "
            "node that no longer exists)",
            ("reason",),
        )
        self.stale_binds_rejected_total = _counter(
            registry, "stale_binds_rejected_total",
            "Solved assignments refused at commit time because the "
            "target node was deleted, cordoned, or unreachable-tainted "
            "between snapshot and commit, by rejecting path "
            "(batch = sidecar pre-commit, bulk = commit_assignments_bulk, "
            "serial = per-pod commit)",
            ("path",),
        )
        self.pod_rescue_seconds = _histogram(
            registry, "pod_rescue_seconds",
            "Eviction-to-rescheduled latency: time from a workload pod "
            "being deleted off a dead node to its replacement being "
            "bound somewhere live",
        )


_default: Optional[FabricMetrics] = None


def fabric_metrics() -> FabricMetrics:
    """Process-wide FabricMetrics bound to the default registry (the
    legacyregistry pattern scheduler_metrics already follows)."""
    global _default
    if _default is None:
        _default = FabricMetrics()
    return _default
