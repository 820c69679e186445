"""The cluster autoscaler's series: nodes provisioned by scale-up
decisions (by group and expander), nodes drained and deleted, the live
size of the unschedulable trigger set, the time from a pending set's
first sight to its draining, and the pods evicted while draining."""

from __future__ import annotations

from typing import Optional

from kubernetes_tpu_torch.metrics.registry import (
    MetricsRegistry,
    counter,
    gauge,
    histogram,
)


class AutoscalerMetrics:
    """Registered into the process registry; an instance built on a
    registry that already holds the series shares them."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        if registry is None:
            from kubernetes_tpu_torch.metrics import default_registry

            registry = default_registry()
        self.registry = registry
        self.scaleups_total = counter(
            registry, "autoscaler_scaleups_total",
            "Nodes provisioned by cluster-autoscaler scale-up decisions, "
            "by node group and expander strategy", ("group", "expander"))
        self.scaledowns_total = counter(
            registry, "autoscaler_scaledowns_total",
            "Nodes drained and deleted by cluster-autoscaler scale-down, "
            "by node group", ("group",))
        self.pending_unschedulable = gauge(
            registry, "autoscaler_pending_unschedulable",
            "Pods currently in the autoscaler's unschedulable trigger "
            "set (queue leftovers + FailedScheduling outcomes)")
        self.time_to_capacity_seconds = histogram(
            registry, "autoscaler_time_to_capacity_seconds",
            "Latency from a pending unschedulable set first appearing "
            "to that set draining to zero",
            # capacity arrives on instance boot times: minutes, not ms
            buckets=(0.5, 1, 2, 5, 10, 20, 30, 60, 120, 300, 600, 1200,
                     1800))
        self.evicted_for_scaledown_total = counter(
            registry, "autoscaler_evicted_for_scaledown_total",
            "Pods evicted (PDB-respecting) while draining a scale-down "
            "candidate node")


_default: Optional[AutoscalerMetrics] = None


def autoscaler_metrics() -> AutoscalerMetrics:
    """The process-wide AutoscalerMetrics on the default registry."""
    global _default
    if _default is None:
        _default = AutoscalerMetrics()
    return _default
