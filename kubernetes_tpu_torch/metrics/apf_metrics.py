"""API Priority & Fairness metrics (reference analogs:
``apiserver_flowcontrol_rejected_requests_total``,
``apiserver_flowcontrol_dispatched_requests_total``,
``apiserver_flowcontrol_current_executing_seats``,
``apiserver_flowcontrol_current_inqueue_requests``,
``apiserver_flowcontrol_request_queue_length_after_enqueue`` /
wait-duration histograms).

Operationally, three questions these answer:

- *who is being pushed back*: ``apf_rejected_requests_total
  {priority_level, reason}`` (queue-full | timeout | shed) — a climbing
  workload-level rate with a flat system-level rate is the subsystem
  working as designed; a climbing SYSTEM rate is an under-provisioned
  control plane;
- *is batching laundering concurrency*: ``apf_seats_dispatched_total /
  apf_dispatched_requests_total`` per level is the average request
  width — bulk-verb abuse shows up as width, not as extra requests;
- *how close to saturation*: ``apf_current_executing_seats`` vs
  ``apf_request_concurrency_limit`` per level, and the queue-wait
  histogram's tail.

``absorb_snapshot`` mirrors a REMOTE server's ``/debug/apf`` totals
into this process's counters, so a harness whose apiserver runs in a
child process reads the server's APF totals in the scheduler's
process.
"""

from __future__ import annotations

from typing import Dict, Optional

from kubernetes_tpu_torch.metrics.fabric_metrics import (
    _counter,
    _gauge,
    _histogram,
)
from kubernetes_tpu_torch.metrics.registry import MetricsRegistry

_QUEUE_WAIT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                       1.0, 2.0, 5.0, 10.0)


class ApfMetrics:
    def __init__(self, registry: Optional[MetricsRegistry] = None):
        if registry is None:
            from kubernetes_tpu_torch.metrics import default_registry

            registry = default_registry()
        self.registry = registry
        self.rejected_requests_total = _counter(
            registry, "apf_rejected_requests_total",
            "Requests rejected by API Priority & Fairness, by priority "
            "level and reason (queue-full, timeout, shed)",
            ("priority_level", "reason"),
        )
        self.dispatched_requests_total = _counter(
            registry, "apf_dispatched_requests_total",
            "Requests admitted to execute by APF, by priority level",
            ("priority_level",),
        )
        self.seats_dispatched_total = _counter(
            registry, "apf_seats_dispatched_total",
            "Seats (request width) admitted to execute by APF, by "
            "priority level — seats/requests is the average width, the "
            "bulk-verb concurrency-laundering detector",
            ("priority_level",),
        )
        self.current_executing_seats = _gauge(
            registry, "apf_current_executing_seats",
            "Seats currently occupied by executing requests, by "
            "priority level",
            ("priority_level",),
        )
        self.current_inqueue_requests = _gauge(
            registry, "apf_current_inqueue_requests",
            "Requests currently waiting in APF queues, by priority level",
            ("priority_level",),
        )
        self.peak_executing_seats = _gauge(
            registry, "apf_peak_executing_seats",
            "High-water mark of executing seats per priority level "
            "since the last diag read — bench rows consume (reset) it "
            "so each row reports its own peak, not the gauge's current "
            "post-run value (~0 once the row's requests drain)",
            ("priority_level",),
        )
        self.request_concurrency_limit = _gauge(
            registry, "apf_request_concurrency_limit",
            "Assured seat budget per priority level (shares of the "
            "legacy lane budgets)",
            ("priority_level",),
        )
        self.request_queue_wait_seconds = _histogram(
            registry, "apf_request_queue_wait_seconds",
            "Time requests spent queued before dispatch or rejection, "
            "by priority level",
            ("priority_level",),
            buckets=_QUEUE_WAIT_BUCKETS,
        )

    # the last absorbed /debug/apf snapshot, kept whole: the queue-wait
    # histogram and peak-seat numbers live server-side and cannot be
    # reconstructed from mirrored counters — a harness reads them from
    # here for rows whose apiserver is another process
    last_snapshot: Optional[Dict] = None

    def absorb_snapshot(self, snap: Dict,
                        instance: Optional[str] = None) -> None:
        """Thin compat wrapper: fold a remote server's /debug/apf
        snapshot totals into this process's counters. Since the SLI
        layer landed, the generic path is ``metrics/federation.py``
        (scrape the child's /metrics, merge + fold EVERY counter family
        — no per-family mapping); this wrapper reshapes the legacy JSON
        snapshot into counter samples and routes them through the
        federation's delta ledger. With the default ``instance=None``
        it keeps the EXACT legacy contract — each call is a different
        server lifetime, so the full totals fold in (the ledger is
        forgotten first; two calls with the same totals double, as the
        old per-family inc did). Pass a stable ``instance`` to share
        the delta ledger with the scrape path instead, so repeated
        absorbs of the same still-running server never double-count."""
        from kubernetes_tpu_torch.metrics.federation import metrics_federation

        self.last_snapshot = snap
        one_shot = instance is None
        if one_shot:
            instance = "debug-apf"
        rejected: Dict[tuple, float] = {}
        dispatched: Dict[tuple, float] = {}
        seats: Dict[tuple, float] = {}
        for name, lv in (snap.get("levels") or {}).items():
            for reason, n in (lv.get("rejected") or {}).items():
                if n:
                    rejected[(name, reason)] = float(n)
            if lv.get("dispatched_total"):
                dispatched[(name,)] = float(lv["dispatched_total"])
            if lv.get("seats_dispatched_total"):
                seats[(name,)] = float(lv["seats_dispatched_total"])
            if lv.get("capacity"):
                self.request_concurrency_limit.set(lv["capacity"], name)
        fed = metrics_federation()
        if one_shot:
            fed.forget_instance(instance)
        fed.fold_samples("apf_rejected_requests_total",
                         ("priority_level", "reason"), rejected, instance,
                         into=self.registry)
        fed.fold_samples("apf_dispatched_requests_total",
                         ("priority_level",), dispatched, instance,
                         into=self.registry)
        fed.fold_samples("apf_seats_dispatched_total",
                         ("priority_level",), seats, instance,
                         into=self.registry)


_default: Optional[ApfMetrics] = None


def apf_metrics() -> ApfMetrics:
    """Process-wide ApfMetrics bound to the default registry (the
    legacyregistry pattern fabric_metrics follows)."""
    global _default
    if _default is None:
        _default = ApfMetrics()
    return _default
