"""The scheduler's series, with the JAX package's names, labels and
buckets: e2e scheduling latency, per-attempt algorithm latency, the
framework's extension-point durations, queue incoming counters, pending
gauges, preemption attempts and victims, binding threads, and the batch
solve's per-phase durations (``phase``: encode, pack, device, scatter,
commit)."""

from __future__ import annotations

from kubernetes_tpu_torch.metrics.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)


class SchedulerMetrics:
    def __init__(self, registry: MetricsRegistry = None):
        self.registry = registry or MetricsRegistry()
        r = self.registry
        self.e2e_scheduling_duration = r.register(
            Histogram(
                "scheduler_e2e_scheduling_duration_seconds",
                "E2e scheduling latency (scheduling algorithm + binding)",
                ("result",),
            )
        )
        self.scheduling_algorithm_duration = r.register(
            Histogram(
                "scheduler_scheduling_algorithm_duration_seconds",
                "Scheduling algorithm latency",
            )
        )
        self.pod_scheduling_duration = r.register(
            Histogram(
                "scheduler_pod_scheduling_duration_seconds",
                "E2e latency for a pod being scheduled, from first attempt",
                ("attempts",),
            )
        )
        self.pod_scheduling_attempts = r.register(
            Histogram(
                "scheduler_pod_scheduling_attempts",
                "Number of attempts to successfully schedule a pod",
                buckets=(1, 2, 4, 8, 16),
            )
        )
        self.schedule_attempts = r.register(
            Counter(
                "scheduler_schedule_attempts_total",
                "Number of attempts to schedule pods, by result",
                ("result", "profile"),
            )
        )
        self.framework_extension_point_duration = r.register(
            Histogram(
                "scheduler_framework_extension_point_duration_seconds",
                "Latency for running all plugins of a specific extension point",
                ("extension_point", "status", "profile"),
            )
        )
        self.queue_incoming_pods = r.register(
            Counter(
                "scheduler_queue_incoming_pods_total",
                "Number of pods added to scheduling queues by event and queue type",
                ("queue", "event"),
            )
        )
        self.pending_pods = r.register(
            Gauge(
                "scheduler_pending_pods",
                "Number of pending pods by queue",
                ("queue",),
            )
        )
        self.preemption_attempts = r.register(
            Counter(
                "scheduler_preemption_attempts_total",
                "Total preemption attempts in the cluster",
            )
        )
        self.preemption_victims = r.register(
            Histogram(
                "scheduler_preemption_victims",
                "Number of selected preemption victims",
                buckets=(1, 2, 4, 8, 16, 32, 64),
            )
        )
        self.cache_size = r.register(
            Gauge(
                "scheduler_scheduler_cache_size",
                "Number of nodes, pods, and assumed pods in the cache",
                ("type",),
            )
        )
        self.goroutines = r.register(
            Gauge(
                "scheduler_scheduler_goroutines",
                "Number of running binding goroutine-equivalents",
                ("work",),
            )
        )
        self.batch_solve_duration = r.register(
            Histogram(
                "scheduler_tpu_batch_solve_duration_seconds",
                "Device batch-solve latency (batch path only)",
                ("phase",),
            )
        )

    # hooks of the framework and the queue
    def observe_extension_point(self, point: str, status: str, seconds: float,
                                profile: str = "") -> None:
        self.framework_extension_point_duration.observe(
            seconds, point, status, profile
        )

    def pods_added(self, queue: str, event: str, amount: float = 1.0) -> None:
        self.queue_incoming_pods.inc(queue, event, amount=amount)

    def pods_moved(self, event: str, amount: float = 1.0) -> None:
        self.queue_incoming_pods.inc("active_or_backoff", event,
                                     amount=amount)
