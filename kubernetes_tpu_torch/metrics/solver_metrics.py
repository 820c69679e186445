"""The solver's per-cycle series, the ``/metrics`` face of
``observability/devprof.py``: compiles by pad bucket and their seconds,
the dispatch-against-wait split around each solve, pad occupancy, the
bytes the pinned ring moved, and the compiles that landed inside a
measured cycle.

On the card a compile is the build and load of the solve kernels'
library or the first launch of a kernel instance (a stall under lazy
module loading), counted where it happens (``ops/solve.py``)."""

from __future__ import annotations

from typing import Optional

from kubernetes_tpu_torch.metrics.registry import (
    MetricsRegistry,
    counter,
    gauge,
    histogram,
)

_COMPILE_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0,
                    20.0, 40.0, 80.0)


class SolverMetrics:
    """Registered into the process registry; an instance built on a
    registry that already holds the series shares them."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        if registry is None:
            from kubernetes_tpu_torch.metrics import default_registry

            registry = default_registry()
        self.registry = registry
        self.compiles_total = counter(
            registry, "solver_compiles_total",
            "Kernel library builds and loads and first launches of a "
            "kernel instance, by padded-shape bucket", ("bucket",))
        self.compile_seconds = histogram(
            registry, "solver_compile_seconds",
            "Wall seconds of compiles per solve cycle that compiled",
            buckets=_COMPILE_BUCKETS)
        self.device_wait_seconds = histogram(
            registry, "solver_device_wait_seconds",
            "Host wall time per solve cycle blocked on the card after the "
            "dispatch")
        self.dispatch_seconds = histogram(
            registry, "solver_dispatch_seconds",
            "Dispatch time per solve cycle (the solve started, before any "
            "wait)")
        self.pad_occupancy_ratio = gauge(
            registry, "solver_pad_occupancy_ratio",
            "Real rows / padded rows of the last solve in each "
            "padded-shape bucket", ("bucket",))
        self.transfer_bytes_total = counter(
            registry, "solver_transfer_bytes_total",
            "Host-device transfer bytes by direction (h2d: pod streams, "
            "plane uploads and scatter entries; d2h: assignments)",
            ("direction",))
        self.unexpected_compiles_total = counter(
            registry, "solver_unexpected_compiles_total",
            "Compiles that landed inside a measured solve cycle (not a "
            "warm-up)")


_default: Optional[SolverMetrics] = None


def solver_metrics() -> SolverMetrics:
    """The process-wide SolverMetrics on the default registry."""
    global _default
    if _default is None:
        _default = SolverMetrics()
    return _default
