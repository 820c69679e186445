"""Sustained arrivals: pods arrive open loop, on a clock, at a target
rate (5,000 a second by default) through the replay engine, while the
batch scheduler pumps; binds are seen on the engine's own watch. The
headline is p99 arrival -> bind, beside throughput normalized by the
offered rate, with zero lost pods as the invariant.

``run_sustained_row`` is the full row (30,000 pods at 5,000 a second);
``run_sustained_cell`` is a small, time-compressed cell for the tests.
Each run opens its own tracer, profiler and SLO window and reports
``telemetry``, ``critical_path`` and ``freshness`` as a harness row does.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Callable, Dict, List, Optional

from kubernetes_tpu_torch.api.types import Node
from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.config.feature_gates import FeatureGates
from kubernetes_tpu_torch.device import resolve_device
from kubernetes_tpu_torch.harness import perf
from kubernetes_tpu_torch.harness.workloads import node_template
from kubernetes_tpu_torch.observability.devprof import get_devprof
from kubernetes_tpu_torch.observability.tracer import get_tracer
from kubernetes_tpu_torch.scheduler.scheduler import (
    Scheduler,
    SchedulerConfiguration,
)
from kubernetes_tpu_torch.sidecar import attach_batch_scheduler
from kubernetes_tpu_torch.utils.gctune import tune_for_throughput
from kubernetes_tpu_torch.workloads.replay import ReplayEngine
from kubernetes_tpu_torch.workloads.trace import (
    Trace,
    events_to_pods,
    generate_trace,
)

SUSTAINED_QPS = 5000.0


def build_sustained_trace(seed: int, pods: int,
                          qps: float = SUSTAINED_QPS) -> Trace:
    """``pods`` Poisson arrivals at ``qps`` with no burst epochs, lightly
    heavy-tailed cpu sizes (100m to 500m) and no lifetimes, so zero lost
    means every arrival bound."""
    return generate_trace(
        seed, pods, pods / qps, family="sustained", name_prefix="su-",
        cpu_alpha=1.8, cpu_lo=100, cpu_hi=500, lifetime_modes=None,
        burst_factor=1.0, burst_period_s=0.0)


def sustained_nodes(trace: Trace, node_cpu: int = 32,
                    headroom: float = 1.25) -> List[dict]:
    """Nodes for the trace: its total cpu demand times ``headroom``, and
    enough pod slots (110 a node) for every arrival, at least 8."""
    demand_milli = sum(e.cpu_milli for e in trace.events)
    n = max(8, math.ceil(demand_milli * headroom / (node_cpu * 1000)),
            math.ceil(len(trace.events) * headroom / 110))
    return [node_template(i, cpu=str(node_cpu), memory="64Gi")
            for i in range(n)]


def _pump_to_quiesce(sched, bs, engine, deadline: float,
                     settle_s: float = 1.0) -> None:
    """Pump until injection is done and the queue has stayed drained for
    ``settle_s``."""
    quiet_since = None
    while time.monotonic() < deadline:
        sched.queue.flush_backoff_completed()
        if bs.run_batch(pop_timeout=0.01):
            quiet_since = None
            continue
        now = time.monotonic()
        busy = (not engine.injection_done.is_set()
                or sched.queue.pending_active_count() > 0)
        if busy:
            quiet_since = None
        elif quiet_since is None:
            quiet_since = now
        elif now - quiet_since >= settle_s:
            return
        time.sleep(0.005)
    raise TimeoutError("sustained replay did not quiesce before deadline")


def run_sustained_once(trace: Trace, *, node_cpu: int = 32,
                       max_batch: int = 4096,
                       pipeline: Optional[bool] = None,
                       mirror: Optional[bool] = None, device=None,
                       wait_timeout: float = 600.0,
                       progress: Optional[Callable[[str], None]] = None):
    """One open-loop run against an in-process store on ``device`` (the
    CUDA card unless "cpu"). Returns the replay stats and the batch
    path's counters."""
    dev = resolve_device(device)
    tune_for_throughput()
    get_tracer().clear()
    get_devprof().reset(workload="sustained")
    perf.reset_sli_window()
    store = ClusterStore()
    for d in sustained_nodes(trace, node_cpu=node_cpu):
        store.add_node(Node.from_dict(d))
    sched = Scheduler(store, config=SchedulerConfiguration(
        provider="GangSchedulingProvider"),
        feature_gates=FeatureGates({"TPUBatchScheduler": True}))
    bs = attach_batch_scheduler(sched, max_batch=max_batch, device=dev,
                                pipeline=pipeline, mirror=mirror)
    perf.attach_slo_baseline(sched)
    sched.start()
    engine = None
    try:
        warm = bs.warmup(events_to_pods(trace.events[:128]))
        if progress and warm > 0.05:
            progress(f"sustained: solver warmup {warm:.1f}s")
        engine = ReplayEngine(store, trace, time_scale=1.0, expire=False,
                              progress=progress)
        t0 = time.monotonic()
        engine.start()
        _pump_to_quiesce(sched, bs, engine, time.monotonic() + wait_timeout)
        bs.flush()
        sched.wait_for_inflight_bindings(timeout=30.0)
        wall = time.monotonic() - t0
        stats = engine.finish()
        engine = None
        session = bs.session
        dp = get_devprof()
        telemetry = dp.summary() if dp.enabled else {}
        extras: Dict = {
            "telemetry": telemetry,
            "critical_path": perf.collect_critical_path()[0],
            "freshness": perf.collect_freshness(telemetry),
            "wall_s": wall,
            "device": str(dev),
            "pipeline": bs.pipeline_info(),
            "mirror": bs.mirror_info(),
            "session": {
                "incremental_hits": session.incremental_hits,
                "rebuilds": session.rebuilds,
                "state_only_rebuilds": session.state_only_rebuilds,
                "carry_chained": session.carry_chained,
                "solves": session.backend.solves,
                "seconds": {**session.seconds, "commit": bs.seconds_commit},
            },
        }
        return stats, extras
    finally:
        if engine is not None:
            engine.finish()
        sched.stop()
        # the collector runs rarely (tune_for_throughput): reclaim this
        # run's garbage now, not inside whatever runs next
        gc.collect()


def run_sustained_row(pods: int = 30_000, qps: float = SUSTAINED_QPS,
                      seed: int = 14, *, node_cpu: int = 32,
                      max_batch: int = 4096,
                      pipeline: Optional[bool] = None,
                      mirror: Optional[bool] = None, device=None,
                      wait_timeout: float = 900.0,
                      progress: Optional[Callable[[str], None]] = None
                      ) -> dict:
    """The sustained-arrival row: p99 arrival -> bind beside throughput
    normalized by the offered rate; zero lost pods is the invariant."""
    trace = build_sustained_trace(seed, pods, qps)
    n_nodes = len(sustained_nodes(trace, node_cpu=node_cpu))
    if progress:
        progress(f"[sustained] {len(trace.events)} arrivals over "
                 f"{trace.duration_s:.1f}s (offered "
                 f"{trace.offered_rate:.0f} pods/s), {n_nodes} nodes, "
                 f"seed {seed}")
    stats, extras = run_sustained_once(
        trace, node_cpu=node_cpu, max_batch=max_batch, pipeline=pipeline,
        mirror=mirror, device=device, wait_timeout=wait_timeout,
        progress=progress)
    offered = stats.offered_rate
    value = (stats.ever_bound / stats.last_bind_s
             if stats.last_bind_s > 0 else 0.0)
    zero_lost = (stats.lost == 0 and stats.injected == stats.expected
                 and not stats.send_errors)
    return {
        "metric": (f"sustained_arrival[open-loop {offered:.0f}/s "
                   f"{n_nodes}nodes/{len(trace.events)}pods seed={seed}]"),
        "value": value,
        "unit": "pods/s",
        "offered_rate_pods_per_sec": offered,
        "rate_normalized_throughput": value / offered if offered else 0.0,
        "p99_arrival_to_bind_ms": stats.latency_p99_ms(),
        "p50_arrival_to_bind_ms": stats.arrival_to_bind["p50"] * 1000,
        "nodes": n_nodes,
        "injected": stats.injected,
        "expected": stats.expected,
        "ever_bound": stats.ever_bound,
        "pending_at_end": stats.pending_at_end,
        "lost_pods": stats.lost,
        "send_errors": stats.send_errors,
        "invariants_ok": zero_lost,
        **extras,
    }


def run_sustained_cell(pods: int = 600, qps: float = 400.0, seed: int = 14,
                       *, node_cpu: int = 16, max_batch: int = 64,
                       pipeline: Optional[bool] = None,
                       mirror: Optional[bool] = None, device=None,
                       wait_timeout: float = 120.0) -> dict:
    """A small open-loop cell (several pipeline cycles at a small batch):
    lost count, p99 and the batch path's counters."""
    trace = build_sustained_trace(seed, pods, qps)
    stats, extras = run_sustained_once(
        trace, node_cpu=node_cpu, max_batch=max_batch, pipeline=pipeline,
        mirror=mirror, device=device, wait_timeout=wait_timeout)
    return {
        "injected": stats.injected,
        "expected": stats.expected,
        "ever_bound": stats.ever_bound,
        "lost": stats.lost,
        "p99_arrival_to_bind_ms": stats.latency_p99_ms(),
        **extras,
    }
