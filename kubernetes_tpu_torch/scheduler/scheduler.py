"""The scheduler: it owns the cache, the queue, the snapshot and one
``Framework`` per profile (``profiles``, keyed by scheduler name: each
profile's plugins merged over its provider's wiring), the extenders,
wires the store's watch into the cache and the queue, and commits
placements.

Two ways to build one:

- ``Scheduler.create(store, config, provider, feature_gates,
  out_of_tree_registry)`` from a v1beta1 ``KubeSchedulerConfiguration``
  (or its dict, or a translated legacy Policy): its profiles, plugin
  sets, weights and args, extenders, ``parallelism``,
  ``percentageOfNodesToScore``, backoff bounds and feature gates. Every
  profile must share one QueueSort;
- ``Scheduler(store, config=SchedulerConfiguration(...))``: one profile
  (``default-scheduler``) on a provider's wiring with plugin args, one
  worker, no extenders, every feature gate at its default.

Two ways in:

- the serial path (``schedule_one``, ``schedule_pod_serial``): one pod
  through the generic algorithm (PreFilter, Filter, Score), then assume,
  Reserve, Permit and Bind; a pod that fits nowhere runs PostFilter
  (preemption) and is recorded unschedulable with the ``FitError``
  message as its ``PodScheduled=False`` condition;
- the batch path (``sidecar.BatchScheduler``): a solved batch commits in
  bulk (``commit_assignments_bulk``) through the same Reserve and Bind
  plugins, and the pods it declines come back through
  ``fail_unschedulable`` or the serial path.

A pod that Permit asks to wait (a gang member) is assumed and parked,
and its binding cycle (wait at Permit, PreBind, Bind, PostBind) runs on
a pool of 64 binding threads, host code only. Against the in-process
store every other pod binds synchronously in the committing call.
Against a remote client (``client.restcluster.RestClusterClient``:
``async_bulk_bind``) a bulk commit's Bind ships on the same pool, so the
batch loop never waits on the round trip or the client's token bucket;
the watch's bind event then confirms the assumed pods whenever it
arrives, and a bind that fails forgets its pods later, which the device
mirror reads as an invalidation (the cache's mutation count moves).
``wait_for_inflight_bindings`` waits for the pool, and ``stop`` waits
for the binds already on it. A binder extender interested in a pod
binds it in place of the Bind plugins.

A remote client's circuit breaker drives degraded mode
(``set_degraded``): while the apiserver is unreachable neither path
pops a pod, and on recovery every parked pod gets another attempt.
``Scheduler.create(..., event_client=)`` records Events through a
client (and token bucket) of their own.

``run()`` schedules on a thread of its own (the batch path's cycles when
one is attached, else the serial path's); ``run_with_leader_election``
does so only while this instance holds the store's lease, binds nothing
once another candidate has taken it, and stops the scheduler for good
once its renew deadline runs out. A replica of a set
(``scheduler.replicas``) owns the pending pods ``pod_shard`` accepts and
caches the nodes ``node_shard`` accepts; ``commit_capacity_guard``
refuses, at commit, a placement whose node a sibling filled since the
solve (``SchedulerCache.commit_fits``). A bind the store refuses because
a sibling got there first unwinds like any refused bind and is counted
by path (``stale_binds_rejected``, and the process-wide
``stale_binds_rejected_total``): ``bind_conflict`` for the partitioned
store's capacity ledger, ``replica_conflict`` for a pod already bound.

Each scheduler counts into its own ``SchedulerMetrics`` (attempts by
result, the e2e and algorithm latency histograms, preemption attempts,
extension-point durations on the attempts that draw plugin metrics,
binding threads), records ``Scheduled``, ``FailedScheduling`` and
``Preempted`` events through its ``EventRecorder`` and the spans of
sampled pods (``queue.wait`` in the queue, ``sched.bind`` at the bind)
and of bulk binds (``bind.bulk``) into the process tracer.

One ``random.Random``
(``rng``) makes every random draw of the serial path, in the order the
JAX package's scheduler makes them from the module-level ``random``: one
plugin-metrics draw per serial attempt, the tie draws of ``select_host``
and the preemption candidate offset.
"""

from __future__ import annotations

import contextlib
import logging
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union

from kubernetes_tpu_torch.apiserver.store import (
    ClusterStore,
    EventHandlers,
    assigned,
)
from kubernetes_tpu_torch.api.types import (
    NO_SCHEDULE,
    TAINT_NODE_UNREACHABLE,
    TAINT_NODE_UNSCHEDULABLE,
    Node,
    Pod,
    PodCondition,
    Taint,
    shallow_copy,
)
from kubernetes_tpu_torch.client.events import EventRecorder
from kubernetes_tpu_torch.config.feature_gates import FeatureGates
from kubernetes_tpu_torch.config.types import (
    KubeSchedulerConfiguration,
    KubeSchedulerProfile,
    PluginConfig,
)
from kubernetes_tpu_torch.metrics.fabric_metrics import fabric_metrics
from kubernetes_tpu_torch.metrics.scheduler_metrics import SchedulerMetrics
from kubernetes_tpu_torch.observability.tracer import get_tracer
from kubernetes_tpu_torch.scheduler.cache import SchedulerCache
from kubernetes_tpu_torch.scheduler.core import GenericScheduler, ScheduleResult
from kubernetes_tpu_torch.scheduler.extender import HTTPExtender
from kubernetes_tpu_torch.scheduler.framework import interface as fw
from kubernetes_tpu_torch.scheduler.framework.cycle_state import CycleState
from kubernetes_tpu_torch.scheduler.framework.plugins import (
    new_in_tree_registry,
)
from kubernetes_tpu_torch.scheduler.framework.plugins.default_preemption import (  # noqa: E501
    DefaultPreemption,
)
from kubernetes_tpu_torch.scheduler.framework.runtime import Framework
from kubernetes_tpu_torch.scheduler.provider import PROVIDERS
from kubernetes_tpu_torch.scheduler.queue import (
    CLIENT_RECOVERED,
    SchedulingQueue,
)
from kubernetes_tpu_torch.scheduler.snapshot import Snapshot
from kubernetes_tpu_torch.scheduler.types import PodInfo, QueuedPodInfo
from kubernetes_tpu_torch.utils.parallelize import Parallelizer

PLUGIN_METRICS_SAMPLE_PERCENT = 10
BIND_WORKERS = 64
CAPACITY_REASON = "out of capacity (concurrent replica commits)"

_logger = logging.getLogger(__name__)


def commit_target_stale(pod: Pod, node: Optional[Node]) -> Optional[str]:
    """Why binding ``pod`` to a node ``SchedulerCache.commit_target_flags``
    flagged would bind into the void ("deleted", "cordoned",
    "unreachable"), or None when the pod may still go there (it tolerates
    the taint)."""
    if node is None:
        return "deleted"
    tolerations = pod.spec.tolerations
    if node.spec.unschedulable:
        cordon = Taint(TAINT_NODE_UNSCHEDULABLE, "", NO_SCHEDULE)
        if not any(t.tolerates(cordon) for t in tolerations):
            return "cordoned"
    for taint in node.spec.taints:
        if taint.key == TAINT_NODE_UNREACHABLE and not any(
                t.tolerates(taint) for t in tolerations):
            return "unreachable"
    return None


@dataclass
class SchedulerConfiguration:
    """The one-profile shorthand: the ``default-scheduler`` profile on
    ``provider``'s wiring (a name in ``provider.PROVIDERS``) with
    ``plugin_config`` (plugin name -> its arguments, for instance
    ``{"Coscheduling": {"permitWaitSeconds": 1.0}}``), one worker
    (``parallelism=1``), no extenders and the default feature gates.
    ``percentage_of_nodes_to_score``: the share of nodes the serial path
    filters before it stops looking (0: the adaptive default). Anything
    more goes through ``Scheduler.create`` and a
    ``KubeSchedulerConfiguration``."""

    percentage_of_nodes_to_score: int = 0
    provider: str = "DefaultProvider"
    plugin_config: Dict[str, dict] = field(default_factory=dict)

    def component_config(self) -> KubeSchedulerConfiguration:
        return KubeSchedulerConfiguration(
            parallelism=1,
            percentage_of_nodes_to_score=self.percentage_of_nodes_to_score,
            profiles=[KubeSchedulerProfile(plugin_config=[
                PluginConfig(name, dict(args))
                for name, args in self.plugin_config.items()])])


class Scheduler:
    def __init__(self, store: ClusterStore,
                 config: Union[SchedulerConfiguration,
                               KubeSchedulerConfiguration, None] = None,
                 rng: Optional[random.Random] = None,
                 provider: Optional[str] = None,
                 feature_gates: Optional[FeatureGates] = None,
                 out_of_tree_registry: Optional[Dict[str, Callable]] = None,
                 event_client=None):
        if config is None or isinstance(config, SchedulerConfiguration):
            short = config or SchedulerConfiguration()
            config = short.component_config()
            provider = provider or short.provider
        provider = provider or "DefaultProvider"
        errs = config.validate()
        if errs:
            raise ValueError("invalid scheduler configuration: "
                             + "; ".join(errs))
        self.feature_gates = feature_gates or FeatureGates(
            config.feature_gates)
        self.client = store
        self.rng = rng if rng is not None else random.Random()
        self.metrics = SchedulerMetrics()
        self.cache = SchedulerCache()
        self.queue = SchedulingQueue(
            metrics=self.metrics,
            pod_initial_backoff=config.pod_initial_backoff_seconds,
            pod_max_backoff=config.pod_max_backoff_seconds)
        self.snapshot = Snapshot()
        self.extenders = [HTTPExtender(e) for e in config.extenders]
        self.algorithm = GenericScheduler(
            self.cache, self.snapshot, self.rng,
            config.percentage_of_nodes_to_score, extenders=self.extenders,
            feature_gates=self.feature_gates)
        self.parallelizer = Parallelizer(config.parallelism)
        registry = new_in_tree_registry()
        registry.update(out_of_tree_registry or {})
        defaults = PROVIDERS[provider](self.feature_gates)
        # scheduler name -> its framework, and its event recorder
        self.profiles: Dict[str, Framework] = {}
        self.recorders: Dict[str, EventRecorder] = {}
        for profile in config.profiles:
            name = profile.scheduler_name
            recorder = self.recorders[name] = EventRecorder(
                event_client or store, name)
            self.profiles[name] = Framework(
                registry,
                profile.plugins.merge_defaults(defaults)
                if profile.plugins is not None else defaults,
                snapshot=lambda: self.snapshot, client=store,
                pod_nominator=self.queue, rng=self.rng, profile_name=name,
                plugin_args={c.name: c.args for c in profile.plugin_config},
                metrics=self.metrics, event_recorder=recorder,
                parallelizer=self.parallelizer, extenders=self.extenders)
        sorts = {tuple(f.list_plugins()["queue_sort"])
                 for f in self.profiles.values()}
        if len(sorts) != 1:
            raise ValueError("all profiles must use the same QueueSort plugin")
        # the first profile's: what a caller of one profile reads
        self.scheduler_name = config.profiles[0].scheduler_name
        self.framework = self.profiles[self.scheduler_name]
        self.recorder = self.recorders[self.scheduler_name]
        self.queue.set_sort_key(self.framework.queue_sort_plugins[0].sort_key)
        # the batch path, when ``sidecar.attach_batch_scheduler`` installed
        # one: ``run`` drives its cycles
        self.batch_scheduler = None
        # a replica of a set (``scheduler.replicas``): the pending pods it
        # owns, the nodes it caches, and the commit-time capacity probe
        self.pod_shard: Optional[Callable[[Pod], bool]] = None
        self.node_shard: Optional[Callable[[str], bool]] = None
        self.commit_capacity_guard = False
        self.replica_name = ""
        # in process, replicas sharing nodes share this lock around the
        # guard's probe and the bind, so no two probes pass on one slot
        self.commit_lock = None
        # placements refused at commit, by path: "serial" and "bulk"
        # (the node died or was cordoned), "capacity" (the guard),
        # "lease" (another candidate holds the lease)
        self.stale_binds_rejected: Dict[str, int] = {}
        self.elector = None
        self.lost_lease = False
        self._stop = threading.Event()
        self._loop_thread: Optional[threading.Thread] = None
        self._bind_pool = ThreadPoolExecutor(max_workers=BIND_WORKERS,
                                             thread_name_prefix="binder")
        self._inflight_bindings = 0
        self._inflight_zero = threading.Condition()
        # binding cycles run on the pool, those that raised, and their
        # seconds waiting at Permit and binding (PreBind to PostBind),
        # summed over cycles
        self.binding_stats = {"cycles": 0, "errors": 0, "wait_s": 0.0,
                              "bind_s": 0.0}
        # a remote client: bulk binds ship on the binding pool
        self.async_bulk_bind = hasattr(store, "breaker")
        # degraded mode: set while a remote client's breaker is open
        self._degraded = threading.Event()
        self._degraded_since = 0.0
        self._degraded_lock = threading.Lock()
        self.event_handlers = EventHandlers(self)
        self._watch_handle = None
        # per bound pod: seconds from its batch's solve start (the
        # pipelined arm: the dispatch's return; the serial path: the
        # attempt's start) to the bind, and from its first enqueue to the
        # bind
        self.cycle_latencies: List[float] = []
        self.pending_latencies: List[float] = []

    @classmethod
    def create(cls, store: ClusterStore,
               config: Union[KubeSchedulerConfiguration, Mapping,
                             None] = None,
               provider: str = "DefaultProvider",
               feature_gates: Optional[FeatureGates] = None,
               out_of_tree_registry: Optional[Dict[str, Callable]] = None,
               rng: Optional[random.Random] = None,
               event_client=None) -> "Scheduler":
        """A scheduler built from a component configuration (a v1beta1
        dict is read with ``KubeSchedulerConfiguration.from_dict``; None
        is the default one: one profile, 16 workers). ``feature_gates``
        defaults to the configuration's own; ``out_of_tree_registry``
        (plugin name -> factory) adds plugins to the in-tree ones;
        ``event_client`` (default: ``store``) is the client the event
        recorders write through. Raises ``ValueError`` on an invalid
        configuration."""
        if isinstance(config, Mapping):
            config = KubeSchedulerConfiguration.from_dict(config)
        return cls(store, config=config or KubeSchedulerConfiguration(),
                   rng=rng, provider=provider, feature_gates=feature_gates,
                   out_of_tree_registry=out_of_tree_registry,
                   event_client=event_client)

    def start(self) -> None:
        """Watch the store, then replay what it already holds (a
        replica's foreign nodes and pods left out). Once only. A remote
        client lists first, with the resourceVersion each list is
        consistent at; the lists are replayed, then the watch streams on
        from those versions, so nothing is missed or delivered twice.
        Its circuit breaker drives degraded mode."""
        if self._watch_handle is not None:
            return
        handlers = self.event_handlers
        set_listener = getattr(self.client, "set_degraded_listener", None)
        if set_listener is not None:
            set_listener(self.set_degraded)
        list_for_watch = getattr(self.client, "list_for_watch", None)
        if list_for_watch is not None:
            initial = list_for_watch()
            nodes, pods = initial["Node"][0], initial["Pod"][0]
        else:
            self._watch_handle = self.client.watch(handlers.handle_many)
            nodes, pods = self.client.list_nodes(), self.client.list_pods()
        for node in nodes:
            if handlers.caches_node(node.name):
                self.cache.add_node(node)
        pending = []
        for pod in pods:
            if assigned(pod):
                if handlers.caches_node(pod.spec.node_name):
                    self.cache.add_pod(pod)
            elif handlers.responsible_for(pod):
                pending.append(pod)
        self.queue.add_many(pending)
        if list_for_watch is not None:
            self._watch_handle = self.client.watch(handlers.handle_many,
                                                   resume=initial)
        for recorder in self.recorders.values():
            recorder.start()

    def run(self) -> threading.Thread:
        """Start, then schedule on a thread of its own until ``stop``."""
        self.start()
        return self._start_loop(f"schedule-{self.replica_name or 'one'}")

    def _start_loop(self, name: str) -> threading.Thread:
        self._loop_thread = threading.Thread(target=self._loop, daemon=True,
                                             name=name)
        self._loop_thread.start()
        return self._loop_thread

    def _loop(self) -> None:
        """The batch path's cycles when one is attached, else the serial
        path's, with the backoff and unschedulable flushes between them;
        a cycle that raises is logged and the loop goes on. A batch still
        held at the stop is dropped: a stopped scheduler binds nothing,
        and its pods stay pending in the store for whoever schedules
        next."""
        while not self._stop.is_set():
            try:
                self.queue.flush_backoff_completed()
                self.queue.flush_unschedulable_left_over()
                if self.batch_scheduler is not None:
                    self.batch_scheduler.run_batch(pop_timeout=0.05)
                else:
                    self.schedule_one(pop_timeout=0.05)
            except Exception:  # noqa: BLE001 - the loop must survive
                _logger.exception("scheduling cycle failed; continuing")

    def run_with_leader_election(self, identity: str = "scheduler-0",
                                 lease_name: str = "kube-scheduler",
                                 clock=None, lease_duration: float = 15.0,
                                 renew_deadline: float = 10.0,
                                 retry_period: float = 2.0):
        """Start (the cache and queue stay warm on a standby), then
        schedule only while this instance holds the store's lease
        ``lease_name``. Losing the lease stops this scheduler for good
        (``lost_lease``): a deposed leader never binds again. Returns the
        ``LeaderElector`` (``is_leader``)."""
        from kubernetes_tpu_torch.client.leaderelection import (
            LeaderElectionConfig,
            LeaderElector,
        )

        self.start()
        self.lost_lease = False

        def on_started() -> None:
            if not self._stop.is_set():
                self._start_loop(f"schedule-{identity}")

        def on_stopped() -> None:
            self.elector.stop()
            if not self._stop.is_set():
                self.lost_lease = True
                self.stop()

        self.elector = LeaderElector(self.client, LeaderElectionConfig(
            lock_name=lease_name, identity=identity,
            lease_duration=lease_duration, renew_deadline=renew_deadline,
            retry_period=retry_period, on_started_leading=on_started,
            on_stopped_leading=on_stopped), clock=clock)
        self.elector.run_in_thread()
        return self.elector

    def stop(self) -> None:
        """Stop the loop (the lease is given up: no renewal outlives the
        scheduler), stop watching; pods still waiting at Permit are
        rejected and the bulk binds already on the pool finish, so no
        binding thread outlives the scheduler, and the Filter and Score
        workers are let go."""
        self._stop.set()
        if self.elector is not None:
            self.elector.stop()
        loop = self._loop_thread
        if loop is not None and loop is not threading.current_thread():
            loop.join(timeout=30.0)
        if self._watch_handle is not None:
            self._watch_handle.stop()
            self._watch_handle = None
        for fwk in self.profiles.values():
            fwk.iterate_waiting_pods(
                lambda wp: wp.reject("", "scheduler stopped"))
        self.wait_for_inflight_bindings()
        self._bind_pool.shutdown(wait=False)
        self.parallelizer.shutdown()
        for recorder in self.recorders.values():
            recorder.stop()

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()

    # ------------------------------------------------------------------
    # degraded mode
    def is_degraded(self) -> bool:
        return self._degraded.is_set()

    def set_degraded(self, degraded: bool) -> None:
        """Enter or leave degraded mode (idempotent; a remote client's
        circuit-breaker listener). Entering pauses both paths' pops;
        leaving adds the outage to ``degraded_mode_seconds`` and moves
        every parked pod back to an attempt, so recovery does not wait
        out a backoff."""
        with self._degraded_lock:
            if degraded == self._degraded.is_set():
                return
            if degraded:
                self._degraded_since = time.monotonic()
                self._degraded.set()
                fabric_metrics().degraded_mode.set(1.0)
            else:
                self._degraded.clear()
                fabric_metrics().degraded_mode.set(0.0)
                fabric_metrics().degraded_mode_seconds.inc(
                    amount=time.monotonic() - self._degraded_since)
        if degraded:
            # the apiserver is unreachable and a crash may follow:
            # flush the flight recorder now (outside the lock: disk I/O)
            tracer = get_tracer()
            tracer.event("sched.degraded_enter")
            if tracer.enabled and len(tracer):
                tracer.dump(reason="degraded", min_interval_s=5.0)
            return
        self.queue.move_all_to_active_or_backoff_queue(CLIENT_RECOVERED)

    def wait_for_inflight_bindings(self, timeout: float = 30.0) -> bool:
        """Wait until no binding cycle runs on the pool; False on
        timeout."""
        deadline = time.monotonic() + timeout
        with self._inflight_zero:
            while self._inflight_bindings > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._inflight_zero.wait(remaining)
            return True

    def update_snapshot(self) -> Snapshot:
        self.algorithm.update_snapshot()
        return self.snapshot

    def framework_for_pod(self, pod: Pod) -> Optional[Framework]:
        """The framework of the pod's scheduler profile; None for a
        profile this scheduler does not run."""
        return self.profiles.get(pod.spec.scheduler_name)

    def skip_pod_schedule(self, pod: Pod) -> bool:
        """Deleting, already-assumed and already-bound pods skip."""
        return (pod.metadata.deletion_timestamp is not None
                or self.cache.is_assumed_pod(pod) or assigned(pod))

    # ------------------------------------------------------------------
    # the serial path
    def schedule_one(self, pop_timeout: Optional[float] = None) -> bool:
        """One serial scheduling cycle. False when the queue yielded
        nothing, or in degraded mode (no pod is popped: it would only
        fail its bind)."""
        if self._degraded.is_set():
            time.sleep(min(pop_timeout or 0.05, 0.05))
            return False
        items, _ = self.queue.pop_batch(1, timeout=pop_timeout)
        if not items:
            return False
        qpi = items[0]
        if self.framework_for_pod(qpi.pod) is None \
                or self.skip_pod_schedule(qpi.pod):
            return True
        self.schedule_pod_serial(qpi)
        return True

    def schedule_pod_serial(self, qpi: QueuedPodInfo) -> None:
        """The generic algorithm and the commit for one popped pod; also
        where the batch path sends the pods it routes to the serial
        path."""
        pod = qpi.pod
        fwk = self.framework_for_pod(pod)
        cycle = self.queue.scheduling_cycle
        start = time.monotonic()
        state = CycleState()
        state.record_plugin_metrics = (
            self.rng.randrange(100) < PLUGIN_METRICS_SAMPLE_PERCENT)
        try:
            result = self.algorithm.schedule(state, fwk, pod)
        except fw.FitError as fit_err:
            self._handle_fit_error(state, qpi, fit_err, cycle)
            self.metrics.schedule_attempts.inc("unschedulable",
                                               fwk.profile_name)
            return
        except Exception as err:  # noqa: BLE001 - the pod is requeued
            self._record_failure(qpi, err, "SchedulerError", "", cycle)
            self.metrics.schedule_attempts.inc("error", fwk.profile_name)
            return
        self.metrics.scheduling_algorithm_duration.observe(
            time.monotonic() - start)
        self.commit_assignment(state, qpi, result, cycle, start)

    def fail_unschedulable(self, qpi: QueuedPodInfo, fit_err: fw.FitError,
                           cycle: int, candidate_hints=None,
                           run_post_filter: bool = True) -> None:
        """Record an unschedulable verdict the batch solve reached: the
        PostFilter (preemption) and requeue of the serial path's
        ``FitError`` branch without its Filter run. PreFilter still runs,
        on a refreshed snapshot: preemption's dry run re-runs Filter on
        the cycle state. ``candidate_hints`` (the preemption screen's
        ranked node names) bound that dry run. ``run_post_filter=False``
        skips preemption when every node failed a node-static predicate
        (preemption cannot help there)."""
        fwk = self.framework_for_pod(qpi.pod)
        state = CycleState()
        if run_post_filter and fwk.has_post_filter_plugins():
            self.algorithm.update_snapshot()
            fwk.run_pre_filter_plugins(state, qpi.pod)
            if candidate_hints is not None:
                state.write(DefaultPreemption.HINTS_KEY, candidate_hints)
            self._handle_fit_error(state, qpi, fit_err, cycle)
        else:
            self._record_failure(qpi, fit_err, "Unschedulable", "", cycle)
        self.metrics.schedule_attempts.inc("unschedulable", fwk.profile_name)

    def commit_assignment(self, state: CycleState, qpi: QueuedPodInfo,
                          result: ScheduleResult, cycle: int,
                          start: float) -> bool:
        """Assume, Reserve, Permit and Bind one pod the serial path
        placed; a failure unreserves, forgets the assume and requeues. A
        pod Permit asks to wait binds on the pool. Returns True when the
        pod was bound in this call."""
        if self._stop.is_set():
            return False   # a stopped scheduler binds nothing
        if self._lease_lost([(qpi, cycle)]):
            return False
        with self.commit_lock or contextlib.nullcontext():
            return self._commit_one(state, qpi, result, cycle, start)

    def _lease_lost(self, refused: List[Tuple[QueuedPodInfo, int]]) -> bool:
        """Has another candidate taken the lease this elected scheduler
        runs under? Then it binds nothing, though its own renew deadline
        has not run out yet: the ``refused`` (qpi, cycle) pairs go back
        to its queue's backoff, with nothing written to the store, and
        are counted under "lease"."""
        if self.elector is None or self.elector.holds_lease():
            return False
        for qpi, cycle in refused:
            try:
                self.queue.add_unschedulable_if_not_present(
                    qpi, cycle, prefer_backoff=True)
            except ValueError:
                pass
        self.note_stale_binds("lease", len(refused))
        return True

    def _commit_one(self, state: CycleState, qpi: QueuedPodInfo,
                    result: ScheduleResult, cycle: int,
                    start: float) -> bool:
        pod = qpi.pod
        host = result.suggested_host
        flagged = self.cache.commit_target_flags((host,))
        if flagged:
            reason = commit_target_stale(pod, flagged[host])
            if reason is not None:
                self._reject_stale_commit(qpi, host, reason, cycle, "serial")
                return False
        if self.commit_capacity_guard and self.cache.commit_fits(
                ((pod, host),))[0] is not None:
            self._reject_stale_commit(qpi, host, CAPACITY_REASON, cycle,
                                      "capacity")
            return False
        assumed = self._assumed_copy(qpi, host)
        try:
            self.cache.assume_pod(assumed)
        except ValueError as err:
            self._record_failure(qpi, err, "SchedulerError", "", cycle)
            return False
        self.queue.delete_nominated_pod_if_exists(pod)
        fwk = self.framework_for_pod(pod)
        status = fwk.run_reserve_plugins_reserve(state, assumed, host)
        if not fw.Status.is_ok(status):
            self._forget_and_fail(qpi, assumed, status.as_error(), cycle)
            return False
        status = fwk.run_permit_plugins(state, assumed, host)
        if status is not None and status.code == fw.WAIT:
            self._submit_binding_cycle(state, qpi, assumed, host, cycle,
                                       start)
            return False
        if status is None:
            status = fwk.run_pre_bind_plugins(state, assumed, host)
        if status is None:
            status = self._bind(fwk, state, assumed, host)
        if not fw.Status.is_ok(status):
            self._unreserve_forget_fail(state, qpi, assumed, host,
                                        status.as_error(), cycle)
            return False
        now = time.monotonic()
        self.cache.finish_binding(assumed, now)
        fwk.run_post_bind_plugins(state, assumed, host)
        self._observe_bound(qpi, start, now, host)
        return True

    # ------------------------------------------------------------------
    # the batch path's commit
    def commit_assignments_bulk(
            self, commits: List[Tuple[QueuedPodInfo, str, int, float]],
            solved: bool = True,
            observed_from: Optional[float] = None) -> Tuple[int, int, int]:
        """Commit (qpi, node name, cycle, start) placements in bulk: one
        cache call assumes them, Reserve, Permit and PreBind run per pod,
        one store call binds them (the bind plugin's ``bind_many``),
        PostBind runs per pod. A placement on a node that died or was
        cordoned is refused before the assume; a pod refused later is
        unreserved, forgotten and requeued. A pod Permit asks to wait
        stays assumed and binds on the pool: its assume is one of this
        call's mutations, and it is neither committed nor failed here.
        ``solved``: the device solve placed these pods (its state already
        counts them); False for placements the host made (preemption
        plans), which the device mirror must scatter. ``observed_from``:
        where given, the e2e histogram and the ``sched.bind`` spans run
        from it rather than from each placement's start (the pipelined
        batch's dispatch; ``cycle_latencies`` keep the start). Returns (committed,
        failed, cache mutations made), failed counting the pods refused
        after the solve counted them."""
        if self._stop.is_set():
            return 0, len(commits), 0   # a stopped scheduler binds nothing
        if self._lease_lost([(c[0], c[2]) for c in commits]):
            return 0, len(commits), 0
        with self.commit_lock or contextlib.nullcontext():
            return self._commit_bulk(commits, solved, observed_from)

    def _commit_bulk(self, commits, solved: bool,
                     observed_from: Optional[float]) -> Tuple[int, int, int]:
        failed = 0
        flagged = self.cache.commit_target_flags(
            {node for _, node, _, _ in commits})
        if flagged:
            live_commits = []
            for item in commits:
                node = flagged.get(item[1], False)
                reason = (commit_target_stale(item[0].pod, node)
                          if node is not False else None)
                if reason is None:
                    live_commits.append(item)
                else:
                    self._reject_stale_commit(item[0], item[1], reason,
                                              item[2], "bulk")
            failed += len(commits) - len(live_commits)
            commits = live_commits
        if self.commit_capacity_guard and commits:
            # one probe for the batch, cumulative per node: a node a
            # sibling replica filled since the solve refuses the rest
            verdicts = self.cache.commit_fits(
                [(qpi.pod, node) for qpi, node, _, _ in commits])
            if any(v is not None for v in verdicts):
                live_commits = []
                for item, verdict in zip(commits, verdicts):
                    if verdict is None:
                        live_commits.append(item)
                    else:
                        self._reject_stale_commit(item[0], item[1],
                                                  CAPACITY_REASON, item[2],
                                                  "capacity")
                failed += len(commits) - len(live_commits)
                commits = live_commits
        assumed_pods = [self._assumed_copy(qpi, node)
                        for qpi, node, _, _ in commits]
        errors = self.cache.assume_pods(assumed_pods, solved=solved)
        live = []
        for item, assumed, err in zip(commits, assumed_pods, errors):
            if err is None:
                live.append((item, assumed))
                self.queue.delete_nominated_pod_if_exists(item[0].pod)
            else:
                self._record_failure(item[0], ValueError(err),
                                     "SchedulerError", "", item[2])
                failed += 1
        # one assume per live pod; each refusal below adds its forget
        mutations = len(live)
        # per profile, in commit order: the pods the bind plugins take in
        # one call
        bindable: Dict[str, list] = {}
        observed = []
        ext_binders = [e for e in self.extenders if e.is_binder()]
        for (qpi, node, cycle, start), assumed in live:
            fwk = self.framework_for_pod(qpi.pod)
            state = CycleState()
            if fwk.reserve_plugins:
                status = fwk.run_reserve_plugins_reserve(state, assumed, node)
                if not fw.Status.is_ok(status):
                    self._forget_and_fail(qpi, assumed, status.as_error(),
                                          cycle)
                    failed += 1
                    mutations += 1
                    continue
            status = None
            if fwk.permit_plugins:
                status = fwk.run_permit_plugins(state, assumed, node)
                if status is not None and status.code == fw.WAIT:
                    self._submit_binding_cycle(state, qpi, assumed, node,
                                               cycle, start)
                    continue
            if status is None and fwk.pre_bind_plugins:
                status = fwk.run_pre_bind_plugins(state, assumed, node)
            if status is None and any(e.is_interested(assumed)
                                      for e in ext_binders):
                # a binder extender takes the pod on its own
                status = self._bind(fwk, state, assumed, node)
                if fw.Status.is_ok(status):
                    self._finish_bound(fwk, state, qpi, assumed, node,
                                       start, observed)
                    continue
            if not fw.Status.is_ok(status):
                self._unreserve_forget_fail(state, qpi, assumed, node,
                                            status.as_error(), cycle)
                failed += 1
                mutations += 1
                continue
            bindable.setdefault(fwk.profile_name, []).append(
                (qpi, node, cycle, start, assumed, state))
        now = time.monotonic()
        for name, group in bindable.items():
            fwk = self.profiles[name]
            if self.async_bulk_bind:
                # the whole group's Bind on the pool: the batch loop
                # keeps solving while the request is on the wire. Its
                # pods already count as assumed; a failure there
                # forgets them later, which moves the cache's mutation
                # count under the device mirror (an invalidation)
                self._submit_bulk_bind(fwk, group, observed_from)
                continue
            bound, n_failed, now = self._bulk_bind_now(fwk, group)
            observed.extend(bound)
            failed += n_failed
            mutations += n_failed   # one forget a refusal
        self._observe_bound_bulk(observed, now, observed_from)
        return len(observed), failed, mutations

    def _bulk_bind_now(self, fwk: Framework, group: list
                       ) -> Tuple[list, int, float]:
        """Bind one profile's (qpi, node, cycle, start, assumed, state)
        group in one call of its bind plugins, then PostBind the bound
        and unreserve, forget and requeue the refused. Returns the bound
        pods' (qpi, start, node), the number refused and the bind's end
        time."""
        t_bind = time.monotonic()
        statuses = fwk.run_bind_plugins_bulk(
            [b[5] for b in group], [b[4] for b in group],
            [b[1] for b in group])
        now = time.monotonic()
        get_tracer().record("bind.bulk", t_bind, now, pods=len(group))
        bound: list = []
        refused = 0
        for (qpi, node, cycle, start, assumed, state), status in zip(
                group, statuses):
            if not fw.Status.is_ok(status):
                self._unreserve_forget_fail(state, qpi, assumed, node,
                                            status.as_error(), cycle)
                refused += 1
                continue
            self._finish_bound(fwk, state, qpi, assumed, node, start,
                               bound, now)
        return bound, refused, now

    def _submit_bulk_bind(self, fwk: Framework, group: list,
                          observed_from: Optional[float]) -> None:
        """Run ``_bulk_bind_now`` for ``group`` on the binding pool."""
        with self._inflight_zero:
            self._inflight_bindings += 1
        self.metrics.goroutines.inc("binding")
        try:
            self._bind_pool.submit(self._complete_bulk_bind, fwk, group,
                                   observed_from)
        except RuntimeError:
            # the pool is shut down (the scheduler stopped): the pods
            # stay assumed until their assume expires
            self._binding_done()

    def _complete_bulk_bind(self, fwk: Framework, group: list,
                            observed_from: Optional[float]) -> None:
        try:
            try:
                bound, _, now = self._bulk_bind_now(fwk, group)
            except Exception as err:  # noqa: BLE001 — the transport died
                # (retries spent, server gone): every pod unwinds as a
                # refused bind does, and retries against what the cluster
                # looks like after the outage
                for qpi, node, cycle, _start, assumed, state in group:
                    self._unreserve_forget_fail(state, qpi, assumed, node,
                                                err, cycle)
                return
            self._observe_bound_bulk(bound, now, observed_from)
        finally:
            self._binding_done()

    def _finish_bound(self, fwk: Framework, state: CycleState,
                      qpi: QueuedPodInfo, assumed: Pod, node: str,
                      start: float, observed: list,
                      now: Optional[float] = None) -> None:
        self.cache.finish_binding(assumed, now)
        fwk.run_post_bind_plugins(state, assumed, node)
        observed.append((qpi, start, node))

    def _bind(self, fwk: Framework, state: CycleState, pod: Pod,
              node_name: str) -> Optional[fw.Status]:
        """A binder extender interested in the pod binds it; else the
        profile's Bind plugins do. None on success."""
        for ext in self.extenders:
            if ext.is_binder() and ext.is_interested(pod):
                try:
                    ext.bind(pod, node_name)
                except Exception as err:  # noqa: BLE001 - the pod requeues
                    return fw.Status(fw.ERROR, str(err))
                return None
        return fwk.run_bind_plugins(state, pod, node_name)

    # ------------------------------------------------------------------
    # the binding pool
    def _submit_binding_cycle(self, state: CycleState, qpi: QueuedPodInfo,
                              assumed: Pod, node_name: str, cycle: int,
                              start: float) -> None:
        """Run the binding cycle of a pod parked at Permit on the pool."""
        with self._inflight_zero:
            self._inflight_bindings += 1
        self.metrics.goroutines.inc("binding")
        try:
            future = self._bind_pool.submit(self._binding_cycle, state, qpi,
                                            assumed, node_name, cycle, start)
        except RuntimeError:
            # the pool is shut down (the scheduler stopped): the pod's
            # state dies with this scheduler
            self._binding_done()
            return
        future.add_done_callback(self._binding_raised)

    def _binding_raised(self, future) -> None:
        """Log and count a binding cycle that raised (its pod stays
        assumed until the assume expires)."""
        if future.cancelled() or future.exception() is None:
            return
        _logger.error("binding cycle failed", exc_info=future.exception())
        with self._inflight_zero:
            self.binding_stats["errors"] += 1

    def _binding_done(self) -> None:
        self.metrics.goroutines.dec("binding")
        with self._inflight_zero:
            self._inflight_bindings -= 1
            if self._inflight_bindings == 0:
                self._inflight_zero.notify_all()

    def _binding_cycle(self, state: CycleState, qpi: QueuedPodInfo,
                       assumed: Pod, node_name: str, cycle: int,
                       start: float) -> bool:
        """Wait at Permit, then PreBind, Bind and PostBind; a rejection or
        a failure unreserves (rejecting the rest of a waiting gang),
        forgets the assume and requeues. Host code only."""
        fwk = self.framework_for_pod(assumed)
        t0 = time.monotonic()
        t1 = None
        try:
            status = fwk.wait_on_permit(assumed)
            t1 = time.monotonic()
            if (status is None and self.elector is not None
                    and not self.elector.holds_lease()):
                # another candidate took the lease while the pod waited
                self.note_stale_binds("lease")
                status = fw.Status(fw.ERROR, "scheduler lost its lease")
            if status is None:
                status = fwk.run_pre_bind_plugins(state, assumed, node_name)
            if status is None:
                try:
                    status = self._bind(fwk, state, assumed, node_name)
                except Exception as err:  # noqa: BLE001 - the pod requeues
                    status = fw.Status(fw.ERROR, str(err))
            if not fw.Status.is_ok(status):
                self._unreserve_forget_fail(state, qpi, assumed, node_name,
                                            status.as_error(), cycle)
                return False
            now = time.monotonic()
            self.cache.finish_binding(assumed, now)
            fwk.run_post_bind_plugins(state, assumed, node_name)
            self._observe_bound(qpi, start, now, node_name)
            return True
        finally:
            t2 = time.monotonic()
            with self._inflight_zero:
                stats = self.binding_stats
                stats["cycles"] += 1
                stats["wait_s"] += (t1 or t2) - t0
                stats["bind_s"] += t2 - (t1 or t2)
            self._binding_done()

    # ------------------------------------------------------------------
    def _assumed_copy(self, qpi: QueuedPodInfo, node_name: str) -> Pod:
        """The pod as assumed on ``node_name``; shares the queue's parse."""
        assumed = shallow_copy(qpi.pod)
        assumed.spec = shallow_copy(qpi.pod.spec)
        assumed.spec.node_name = node_name
        PodInfo.derived(assumed, qpi.pod_info)
        return assumed

    def _observe_bound(self, qpi: QueuedPodInfo, start: float, now: float,
                       node_name: str) -> None:
        self._observe_bound_bulk([(qpi, start, node_name)], now)

    def _observe_bound_bulk(self, observed: List[Tuple[QueuedPodInfo, float,
                                                       str]],
                            now: float,
                            observed_from: Optional[float] = None) -> None:
        """The latencies, metrics, ``sched.bind`` spans and ``Scheduled``
        events of (qpi, start, node name) pods bound at ``now``; each
        metric's lock is taken once for the lot. ``cycle_latencies`` run
        from each start; the e2e histogram and the spans from
        ``observed_from`` where given."""
        if not observed:
            return
        m = self.metrics
        e2e = [now - start for _, start, _ in observed]
        self.cycle_latencies.extend(e2e)
        if observed_from is not None:
            e2e = [now - observed_from] * len(observed)
        m.e2e_scheduling_duration.observe_many(e2e, "scheduled")
        by_profile: Dict[str, int] = {}
        for qpi, _, _ in observed:
            name = qpi.pod.spec.scheduler_name
            by_profile[name] = by_profile.get(name, 0) + 1
        for name, n in by_profile.items():
            m.schedule_attempts.inc("scheduled", name, amount=n)
        m.pod_scheduling_attempts.observe_many(
            [qpi.attempts for qpi, _, _ in observed])
        by_attempts: Dict[int, List[float]] = {}
        for qpi, _, _ in observed:
            pending = now - qpi.initial_attempt_timestamp
            self.pending_latencies.append(pending)
            by_attempts.setdefault(qpi.attempts, []).append(pending)
        for attempts, values in by_attempts.items():
            m.pod_scheduling_duration.observe_many(values, str(attempts))
        tracer = get_tracer()
        if tracer.enabled:
            for qpi, start, node_name in observed:
                uid = qpi.pod.uid
                if uid and tracer.sampled(uid):
                    tracer.record("sched.bind",
                                  start if observed_from is None
                                  else observed_from, now, trace=uid,
                                  node=node_name, attempts=qpi.attempts)
        for qpi, _, node_name in observed:
            pod = qpi.pod
            self.recorders[pod.spec.scheduler_name].eventf(
                pod, "Normal", "Scheduled",
                "Successfully assigned %s/%s to %s",
                pod.namespace, pod.name, node_name)

    def _handle_fit_error(self, state: CycleState, qpi: QueuedPodInfo,
                          fit_err: fw.FitError, cycle: int) -> None:
        """PostFilter (preemption), then record and requeue."""
        nominated_node = ""
        fwk = self.framework_for_pod(qpi.pod)
        if fwk.has_post_filter_plugins():
            self.metrics.preemption_attempts.inc()
            result, status = fwk.run_post_filter_plugins(
                state, qpi.pod, fit_err.filtered_nodes_statuses)
            if fw.Status.is_ok(status) and result is not None:
                nominated_node = result.nominated_node_name
        self._record_failure(qpi, fit_err, "Unschedulable", nominated_node,
                             cycle)

    def _forget_and_fail(self, qpi: QueuedPodInfo, assumed: Pod,
                         err: Exception, cycle: int) -> None:
        try:
            self.cache.forget_pod(assumed)
        except ValueError:
            pass
        self._record_failure(qpi, err, "SchedulerError", "", cycle)

    def _unreserve_forget_fail(self, state: CycleState, qpi: QueuedPodInfo,
                               assumed: Pod, node_name: str, err: Exception,
                               cycle: int) -> None:
        self._note_bind_conflict(err)
        fwk = self.framework_for_pod(assumed)
        fwk.run_reserve_plugins_unreserve(state, assumed, node_name)
        gang = fwk.get_plugin("Coscheduling")
        if gang is not None:
            gang.unreserve_group(assumed)
        self._forget_and_fail(qpi, assumed, err, cycle)

    def _reject_stale_commit(self, qpi: QueuedPodInfo, node_name: str,
                             reason: str, cycle: int, path: str) -> None:
        """Refuse a placement on a node that died or was cordoned since
        the snapshot, or (``path`` "capacity") that a sibling replica
        filled; count it by path; the pod retries on the backoff
        curve."""
        self.note_stale_binds(path)
        err = RuntimeError(
            f"commit target node {node_name!r} is {reason} "
            f"(assignment solved against a stale snapshot)")
        self._record_failure(qpi, err, "SchedulerError", "", cycle)

    def _note_bind_conflict(self, err: Exception) -> None:
        """Count a bind the store refused because another writer got
        there first: "capacity conflict" (the partitioned store's ledger
        settled a node race: ``bind_conflict``), "already assigned" or
        "uid mismatch" (a sibling bound the pod, or it was recreated:
        ``replica_conflict``). The pod unwinds as any refused bind."""
        msg = str(err)
        if "capacity conflict" in msg:
            self.note_stale_binds("bind_conflict")
        elif "already assigned" in msg or "uid mismatch" in msg:
            self.note_stale_binds("replica_conflict")

    def note_stale_binds(self, path: str, amount: int = 1) -> None:
        """Count ``amount`` refused commits under ``path``, here and on
        the process-wide ``stale_binds_rejected_total{path}``."""
        with self._inflight_zero:
            self.stale_binds_rejected[path] = (
                self.stale_binds_rejected.get(path, 0) + amount)
        fabric_metrics().stale_binds_rejected_total.inc(path, amount=amount)

    def _record_failure(self, qpi: QueuedPodInfo, err: Exception,
                        reason: str, nominated_node: str,
                        cycle: int) -> None:
        """Write ``PodScheduled=False`` with ``err`` as its message (and
        the nominated node, if any) on the pod, and requeue it while it
        still exists unassigned: a scheduler error to backoff, a fit
        failure to the unschedulable set."""
        pod = qpi.pod
        self.recorders.get(pod.spec.scheduler_name, self.recorder).event(
            pod, "Warning", "FailedScheduling", str(err))
        self.client.patch_pod_condition(
            pod.namespace, pod.name,
            PodCondition("PodScheduled", "False", reason, str(err)))
        if nominated_node:
            self.client.set_nominated_node_name(pod.namespace, pod.name,
                                                nominated_node)
            pod.status.nominated_node_name = nominated_node
            self.queue.add_nominated_pod(pod, nominated_node)
        current = self.client.get_pod(pod.namespace, pod.name)
        if current is not None and not assigned(current):
            try:
                self.queue.add_unschedulable_if_not_present(
                    qpi, cycle, prefer_backoff=(reason == "SchedulerError"))
            except ValueError:
                pass
