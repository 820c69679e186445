"""Metrics of the port: the registry primitives, the scheduler's series
(``scheduler_metrics``), the solver's per-cycle series that the device
profiler mirrors (``solver_metrics``) and the freshness SLIs
(``freshness_metrics``)."""

from kubernetes_tpu_torch.metrics.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from kubernetes_tpu_torch.metrics.scheduler_metrics import SchedulerMetrics

# the process-wide registry: components register here unless given one
_default_registry = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _default_registry


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "SchedulerMetrics", "default_registry"]
