"""scheduler_perf-style runner: executes an op list against an in-process
store and the batch scheduler (binding is the finish line), samples the
bound-pod count at 1 Hz and reports throughput and per-pod latency.

Besides creating nodes and pods, an op list can churn the cluster
between pumps (``workloads.churn``): delete a seeded share of the bound
pods, change a seeded share of the nodes' allocatable cpu, and delete a
pod while a solved batch waits for its commit.

A ``setup`` op calls its ``fn`` with the store (the volume rows' PVs,
claims, StorageClasses and CSINodes).

A ``createPods`` op waits for its own pods to be bound in the store (none
when it sets ``skipWaitToCompletion``), not for every pod: pods of
earlier ops may pend for good (Unschedulable) or be deleted by
preemption (victims), and neither is a lost pod. A pod assumed and
waiting at Permit for its gang is not bound yet; a run ends when no
binding cycle is in flight.

Every row runs the gang scheduling provider: its queue sort is
PrioritySort's order for pods of no gang, and its Permit lets them
through at once.

Each row opens a fresh window of the process tracer, the device profiler
and the freshness SLIs and SLO engine, and reports what the JAX harness
reports from them: ``telemetry`` (the profiler's summary),
``critical_path`` (the per-phase attribution of the sampled pods'
windows, without the per-pod list) and ``freshness`` (staleness and the
SLO verdicts)."""

from __future__ import annotations

import gc
import math
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.resource import parse_quantity
from kubernetes_tpu_torch.api.types import Node, Pod, shallow_copy
from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.config.feature_gates import FeatureGates
from kubernetes_tpu_torch.config.types import KubeSchedulerConfiguration
from kubernetes_tpu_torch.device import resolve_device
from kubernetes_tpu_torch.metrics.freshness_metrics import (
    freshness_metrics,
    freshness_row_summary,
)
from kubernetes_tpu_torch.observability.devprof import get_devprof
from kubernetes_tpu_torch.observability.fleettrace import collect_fleet_trace
from kubernetes_tpu_torch.observability.slo import get_slo_engine
from kubernetes_tpu_torch.observability.tracer import get_tracer
from kubernetes_tpu_torch.scheduler.scheduler import (
    Scheduler,
    SchedulerConfiguration,
)
from kubernetes_tpu_torch.sidecar import attach_batch_scheduler
from kubernetes_tpu_torch.utils.gctune import tune_for_throughput

# an op's pods must all be bound within this long
WAIT_TIMEOUT_S = 600.0


def sample_percentile(samples: List[float], q: float) -> float:
    """Nearest-rank percentile of the exact samples (0 when empty)."""
    if not samples:
        return 0.0
    s = sorted(samples)
    return s[min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))]


def _percentiles(samples: List[float], scale: float = 1.0
                 ) -> Dict[str, float]:
    return {f"Perc{int(q * 100)}": sample_percentile(samples, q) * scale
            for q in (0.50, 0.90, 0.99)}


class ThroughputCollector:
    """Samples the bound-pod count of the store (or ``count_fn()``, where
    the store is in another process) once per ``interval``."""

    def __init__(self, store: Optional[ClusterStore] = None,
                 interval: float = 1.0, count_fn=None):
        # a counter, not a scan: the sampling thread must not hold the
        # interpreter for milliseconds while the batch loop dispatches
        self._count_scheduled = count_fn or store.count_bound
        self.interval = interval
        self.samples: List[float] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        last = self._count_scheduled()
        while not self._stop.wait(self.interval):
            now = self._count_scheduled()
            self.samples.append((now - last) / self.interval)
            last = now

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)

    def summary(self) -> Dict[str, float]:
        samples = list(self.samples) or [0.0]
        return {"Average": sum(samples) / len(samples),
                **_percentiles(samples)}


@dataclass
class BenchmarkResult:
    name: str
    device: str
    total_pods: int
    measured_pods: int
    duration_seconds: float
    pods_per_second: float
    throughput: Dict[str, float]
    # per bound pod, ms from its batch's solve start (pipelined: from its
    # dispatch's return) to its bind
    metrics: Dict[str, float] = field(default_factory=dict)
    # per bound pod, ms from its first enqueue to its bind
    latency: Dict[str, float] = field(default_factory=dict)
    solves: int = 0
    rebuilds: int = 0
    # of those, rebuilds that kept the resident static planes
    state_only_rebuilds: int = 0
    pipeline: bool = True
    mirror: bool = True
    # lazy solves dispatched while the previous batch was in flight
    carry_chained: int = 0
    # the pipelined arm's depth and discards, the mirror's counters, the
    # backend's scatters (None where the arm is off)
    pipeline_info: Optional[Dict[str, int]] = None
    mirror_info: Optional[Dict[str, int]] = None
    scatters: Dict[str, int] = field(default_factory=dict)
    # per lazy solve: host seconds from dispatch to materialize, and the
    # seconds materialize waited for the card
    handoffs: List[Tuple[float, float]] = field(default_factory=list)
    # pods the op list deleted (churn)
    deleted_pods: int = 0
    # pods preemption deleted (created, not deleted by the op list, and
    # gone at the end)
    victims: int = 0
    # PostFilter runs, and the host seconds of the paths behind the
    # solve (``BatchScheduler.seconds``)
    post_filter_runs: int = 0
    host_paths: Dict[str, float] = field(default_factory=dict)
    # pod name -> (status, reason, message) of its PodScheduled condition,
    # for every pod left with one
    conditions: Dict[str, Tuple[str, str, str]] = field(default_factory=dict)
    # host seconds per phase of the batch path, and of the measured
    # window's pod builds (parse) and creates (admit)
    seconds: Dict[str, float] = field(default_factory=dict)
    # pod name -> node name of every pod the run created
    placements: Dict[str, str] = field(default_factory=dict)
    # binding cycles of pods parked at Permit (``Scheduler.binding_stats``)
    # and the pods still waiting at Permit when the run ended
    binding: Dict[str, float] = field(default_factory=dict)
    waiting_at_end: int = 0
    # claim name -> the PV bound to it ("" when unbound), for every claim
    # in the store; node name -> the PVs its bound pods' claims use; the
    # claims the batch loop bound at commit
    claims: Dict[str, str] = field(default_factory=dict)
    node_volumes: Dict[str, List[str]] = field(default_factory=dict)
    volumes_bound: int = 0
    # the device profiler's summary, the critical-path aggregate and the
    # freshness SLIs with the SLO verdicts, of this row's window
    telemetry: Dict[str, object] = field(default_factory=dict)
    critical_path: Dict[str, object] = field(default_factory=dict)
    freshness: Dict[str, object] = field(default_factory=dict)
    # the drain size the latency-budget tuner ended at, and the pad
    # buckets warmed
    chunk: int = 0
    warmed_pads: List[int] = field(default_factory=list)


def reset_sli_window() -> None:
    """A fresh freshness and SLO window for one row."""
    freshness_metrics().reset_window()
    get_slo_engine().reset(extra_registries=[])


def attach_slo_baseline(sched) -> None:
    """Point the SLO engine at the row's scheduler registry and take the
    baseline sample."""
    engine = get_slo_engine()
    if engine.enabled:
        engine.add_registry(sched.metrics.registry)
        engine.tick()


def collect_freshness(devprof_summary=None) -> dict:
    """The row's ``freshness``: staleness and the final SLO verdicts of
    the window ``reset_sli_window`` opened."""
    engine = get_slo_engine()
    slos = engine.evaluate().get("slos") if engine.enabled else None
    return freshness_row_summary(devprof_summary, slos)


def collect_critical_path(remote=(), token: str = "", max_pods: int = 25):
    """(the row's ``critical_path`` without the per-pod list, the merged
    trace document); ({}, None) when tracing is off or no pod was
    sampled. Always absorbs this process's ring as ``scheduler``;
    ``remote`` adds (instance, url) pairs, each an apiserver whose
    ``/debug/trace`` is scraped with the clock-offset handshake
    (``token`` authenticates the scrape)."""
    tracer = get_tracer()
    if not tracer.enabled:
        return {}, None
    doc, cp = collect_fleet_trace(remote=remote,
                                  local=[("scheduler", tracer)],
                                  token=token, max_pods=max_pods)
    if not cp.get("pods"):
        return {}, None
    return {k: v for k, v in cp.items() if k != "per_pod"}, doc


def _bound_pods(store: ClusterStore) -> List[Pod]:
    return sorted((p for p in store.list_pods() if p.spec.node_name),
                  key=lambda p: p.metadata.name)


def delete_bound_share(store: ClusterStore, fraction: float, seed: int,
                       at_least: int = 0) -> int:
    """Delete a seeded ``fraction`` of the bound pods (``at_least`` of
    them) in one bulk call. Returns how many."""
    bound = _bound_pods(store)
    picks = random.Random(seed).sample(
        bound, min(len(bound), max(at_least, int(len(bound) * fraction))))
    store.delete_pods([(p.namespace, p.name) for p in picks])
    return len(picks)


def update_node_cpu_share(store: ClusterStore, fraction: float, seed: int
                          ) -> int:
    """Give a seeded ``fraction`` of the nodes a new allocatable cpu (a
    seeded pick of 28 to 36), nothing else changed. Returns how many."""
    rng = random.Random(seed)
    nodes = sorted(store.list_nodes(), key=lambda n: n.name)
    picks = rng.sample(nodes, int(len(nodes) * fraction))
    for node in picks:
        new = shallow_copy(node)
        new.metadata = shallow_copy(node.metadata)
        new.status = shallow_copy(node.status)
        new.status.allocatable = dict(node.status.allocatable,
                                      cpu=parse_quantity(rng.choice(
                                          ("28", "30", "34", "36"))))
        store.update_node(new)
    return len(picks)


def run_workload(name: str, ops: List[dict], max_batch: int = 4096,
                 device=None, pipeline: Optional[bool] = None,
                 mirror: Optional[bool] = None,
                 seed: Optional[int] = None, adaptive_chunk: bool = True,
                 configure=None, backend_factory=None,
                 config=None) -> BenchmarkResult:
    """Execute one workload on ``device`` (the CUDA card unless "cpu" is
    passed; raises when no card is available). ``pipeline`` and
    ``mirror`` switch the batch path's arms (default: the environment's
    ``KTPU_PIPELINE`` and ``KTPU_MIRROR``, both on); ``seed`` seeds the
    scheduler's random draws (ties of the serial path, the preemption
    candidate offset); ``adaptive_chunk`` False pins the drain and pad
    size at ``max_batch``; ``configure(batch_scheduler)`` runs before the
    first op. ``backend_factory()``, when given, makes the session's
    solve backend (the sharded tier's ``ShardedBackend``, say), which
    then sets the device. ``config``, when given (a
    ``KubeSchedulerConfiguration`` or its v1beta1 dict), builds the
    scheduler through ``Scheduler.create`` over the gang scheduling
    provider; by default it is the one-profile ``SchedulerConfiguration``
    on that provider. Either way the ``TPUBatchScheduler`` gate is on."""
    backend = backend_factory() if backend_factory is not None else None
    dev = backend.device if backend is not None else resolve_device(device)
    tune_for_throughput()
    get_tracer().clear()
    get_devprof().reset(workload=name)
    reset_sli_window()
    store = ClusterStore()
    if config is None:
        sched = Scheduler(
            store, config=SchedulerConfiguration(
                provider="GangSchedulingProvider"),
            rng=random.Random(seed),
            feature_gates=FeatureGates({"TPUBatchScheduler": True}))
    else:
        if isinstance(config, dict):
            config = KubeSchedulerConfiguration.from_dict(config)
        sched = Scheduler.create(
            store, config=config, provider="GangSchedulingProvider",
            feature_gates=FeatureGates({**config.feature_gates,
                                        "TPUBatchScheduler": True}),
            rng=random.Random(seed))
    bs = attach_batch_scheduler(sched, max_batch=max_batch, device=dev,
                                pipeline=pipeline, mirror=mirror,
                                adaptive_chunk=adaptive_chunk,
                                backend=backend)
    if configure is not None:
        configure(bs)
    attach_slo_baseline(sched)
    sched.start()

    def pump(deadline: float, wait_names=None) -> None:
        """Schedule until every pod in ``wait_names`` is bound, or, without
        names, until no pod is due an attempt and no binding cycle is in
        flight."""
        def op_done() -> bool:
            bound = sum(1 for p in store.list_pods()
                        if p.spec.node_name and p.metadata.name in wait_names)
            return bound >= len(wait_names)

        while time.monotonic() < deadline:
            sched.queue.flush_backoff_completed()
            sched.queue.flush_unschedulable_left_over()
            progressed = bs.run_batch(pop_timeout=0.01)
            if wait_names is not None and op_done():
                return
            if progressed:
                continue
            if sched.queue.pending_active_count() == 0:
                # a failed binding cycle requeues its pod: settle them
                sched.wait_for_inflight_bindings(timeout=10.0)
                sched.queue.flush_backoff_completed()
                if sched.queue.pending_active_count() == 0 and (
                        wait_names is None or op_done()):
                    bs.flush()
                    return
            time.sleep(0.005)
        raise TimeoutError(
            f"workload {name}: not all pods scheduled before deadline")

    collector: Optional[ThroughputCollector] = None
    measure_start = 0.0
    measured_pods = 0
    created_nodes = 0
    created_pods = 0
    deleted_pods = 0
    # seconds of the measured window spent building the op's pods from
    # their dicts (parse) and in the store's pod creates, their watch
    # delivery into the queue included (admit)
    parse_s = admit_s = 0.0
    try:
        for op in ops:
            opcode = op["opcode"]
            if opcode == "createNodes":
                for _ in range(op["count"]):
                    store.add_node(Node.from_dict(
                        op["nodeTemplate"](created_nodes)))
                    created_nodes += 1
            elif opcode == "createPods":
                template = op["podTemplate"]
                offset = op.get("offset", 0)
                if op["count"] == 0:
                    continue
                if op.get("collectMetrics", False) and collector is None:
                    # build and load the kernel outside the measured window
                    bs.warmup([Pod.from_dict(template(offset + i))
                               for i in range(min(200, op["count"]))])
                    collector = ThroughputCollector(store)
                    measure_start = time.monotonic()
                    collector.start()
                if op.get("collectMetrics", False):
                    measured_pods += op["count"]
                t0 = time.monotonic()
                new_pods = [Pod.from_dict(template(offset + i))
                            for i in range(op["count"])]
                t1 = time.monotonic()
                store.create_pods(new_pods)
                if collector is not None:
                    parse_s += t1 - t0
                    admit_s += time.monotonic() - t1
                created_pods += len(new_pods)
                if op.get("skipWaitToCompletion", False):
                    continue
                if "deleteWhilePending" in op:
                    # one cycle leaves a solved batch held; a bound pod
                    # deleted now lands while it waits
                    bs.run_batch(pop_timeout=0.01)
                    if bs.holding:
                        deleted_pods += delete_bound_share(
                            store, 0.0, op["deleteWhilePending"], 1)
                pump(time.monotonic() + WAIT_TIMEOUT_S,
                     wait_names={p.metadata.name for p in new_pods})
            elif opcode == "deletePods":
                deleted_pods += delete_bound_share(store, op["fraction"],
                                                   op["seed"])
                pump(time.monotonic() + WAIT_TIMEOUT_S)
            elif opcode == "updateNodes":
                update_node_cpu_share(store, op["fraction"], op["seed"])
                pump(time.monotonic() + WAIT_TIMEOUT_S)
            elif opcode == "barrier":
                pump(time.monotonic() + WAIT_TIMEOUT_S)
            elif opcode == "setup":
                op["fn"](store)
            else:
                raise ValueError(f"unknown opcode {opcode!r}")
        bs.flush()
        if not sched.wait_for_inflight_bindings(timeout=30.0):
            raise TimeoutError(f"workload {name}: bindings still in flight")
        duration = time.monotonic() - measure_start if measure_start else 0.0
        waiting: List = []
        for fwk in sched.profiles.values():
            fwk.iterate_waiting_pods(waiting.append)
    finally:
        if collector:
            collector.stop()
        sched.stop()
        # the collector runs rarely (tune_for_throughput): reclaim this
        # run's garbage now, not inside whatever runs next
        gc.collect()

    dp = get_devprof()
    telemetry = dp.summary() if dp.enabled else {}
    critical_path, _ = collect_critical_path()
    session = bs.session
    pods = store.list_pods()
    claims = {pvc.name: pvc.volume_name for pvc in store.list_all_pvcs()}
    node_volumes: Dict[str, set] = {}
    for p in pods:
        for v in p.spec.volumes:
            pv = claims.get(v.persistent_volume_claim or "")
            if p.spec.node_name and pv:
                node_volumes.setdefault(p.spec.node_name, set()).add(pv)
    return BenchmarkResult(
        name=name,
        device=str(dev),
        total_pods=created_pods,
        measured_pods=measured_pods,
        duration_seconds=duration,
        pods_per_second=(measured_pods / duration) if duration > 0 else 0.0,
        throughput=collector.summary() if collector else {},
        metrics=_percentiles(sched.cycle_latencies, 1000.0),
        latency=_percentiles(sched.pending_latencies, 1000.0),
        solves=session.backend.solves,
        rebuilds=session.rebuilds,
        state_only_rebuilds=session.state_only_rebuilds,
        seconds={**session.seconds, "commit": bs.seconds_commit,
                 "parse": parse_s, "admit": admit_s},
        pipeline=bs.pipeline_enabled,
        mirror=session.mirror is not None,
        carry_chained=session.carry_chained,
        pipeline_info=bs.pipeline_info(),
        mirror_info=bs.mirror_info(),
        scatters={**session.backend.scatters,
                  "bytes": session.backend.scatter_bytes},
        handoffs=list(session.handoffs),
        deleted_pods=deleted_pods,
        victims=created_pods - deleted_pods - len(pods),
        post_filter_runs=sum(f.post_filter_runs
                             for f in sched.profiles.values()),
        host_paths=dict(bs.seconds),
        conditions={p.metadata.name: (c.status, c.reason, c.message)
                    for p in pods for c in p.status.conditions
                    if c.type == "PodScheduled"},
        placements={p.metadata.name: p.spec.node_name for p in pods},
        binding=dict(sched.binding_stats),
        waiting_at_end=len(waiting),
        claims=claims,
        node_volumes={n: sorted(v) for n, v in node_volumes.items()},
        volumes_bound=bs.volumes_bound,
        telemetry=telemetry,
        critical_path=critical_path,
        freshness=collect_freshness(telemetry),
        chunk=bs._chunk,
        warmed_pads=sorted(bs._warmed_pads),
    )
