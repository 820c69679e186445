"""The scheduler: it owns the cache, the queue, the snapshot and one
``Framework`` (its provider's wiring: the default one, or the gang
scheduling one), wires the store's watch into the cache and the queue,
and commits placements.

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
a pool of 64 binding threads, host code only; every other pod binds
synchronously in the committing call, since the store is in process.
``wait_for_inflight_bindings`` waits for the pool.

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

import logging
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

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
from kubernetes_tpu_torch.metrics.scheduler_metrics import SchedulerMetrics
from kubernetes_tpu_torch.observability.tracer import get_tracer
from kubernetes_tpu_torch.scheduler.cache import SchedulerCache
from kubernetes_tpu_torch.scheduler.core import GenericScheduler, ScheduleResult
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
from kubernetes_tpu_torch.scheduler.queue import SchedulingQueue
from kubernetes_tpu_torch.scheduler.snapshot import Snapshot
from kubernetes_tpu_torch.scheduler.types import PodInfo, QueuedPodInfo

PLUGIN_METRICS_SAMPLE_PERCENT = 10
BIND_WORKERS = 64

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
    """``percentage_of_nodes_to_score``: the share of nodes the serial
    path filters before it stops looking (0: the adaptive default);
    ``provider``: a name in ``provider.PROVIDERS``; ``plugin_config``:
    plugin name -> its arguments (for instance ``{"Coscheduling":
    {"permitWaitSeconds": 1.0}}``)."""

    percentage_of_nodes_to_score: int = 0
    provider: str = "DefaultProvider"
    plugin_config: Dict[str, dict] = field(default_factory=dict)


class Scheduler:
    scheduler_name = "default-scheduler"

    def __init__(self, store: ClusterStore,
                 config: Optional[SchedulerConfiguration] = None,
                 rng: Optional[random.Random] = None):
        config = config or SchedulerConfiguration()
        self.client = store
        self.rng = rng if rng is not None else random.Random()
        self.metrics = SchedulerMetrics()
        self.recorder = EventRecorder(store, self.scheduler_name)
        self.cache = SchedulerCache()
        self.queue = SchedulingQueue(metrics=self.metrics)
        self.snapshot = Snapshot()
        self.algorithm = GenericScheduler(
            self.cache, self.snapshot, self.rng,
            config.percentage_of_nodes_to_score)
        self.framework = Framework(
            new_in_tree_registry(), PROVIDERS[config.provider](),
            snapshot=lambda: self.snapshot, client=store,
            pod_nominator=self.queue, rng=self.rng,
            profile_name=self.scheduler_name,
            plugin_args=config.plugin_config, metrics=self.metrics,
            event_recorder=self.recorder)
        self.queue.set_sort_key(self.framework.queue_sort_plugins[0].sort_key)
        self._bind_pool = ThreadPoolExecutor(max_workers=BIND_WORKERS,
                                             thread_name_prefix="binder")
        self._inflight_bindings = 0
        self._inflight_zero = threading.Condition()
        # binding cycles run on the pool, those that raised, and their
        # seconds waiting at Permit and binding (PreBind to PostBind),
        # summed over cycles
        self.binding_stats = {"cycles": 0, "errors": 0, "wait_s": 0.0,
                              "bind_s": 0.0}
        self.event_handlers = EventHandlers(self)
        self._watch_handle = None
        # per bound pod: seconds from its batch's solve start (the
        # pipelined arm: the dispatch's return; the serial path: the
        # attempt's start) to the bind, and from its first enqueue to the
        # bind
        self.cycle_latencies: List[float] = []
        self.pending_latencies: List[float] = []

    def start(self) -> None:
        """Watch the store, then replay what it already holds."""
        if self._watch_handle is None:
            self._watch_handle = self.client.watch(
                self.event_handlers.handle_many)
        for node in self.client.list_nodes():
            self.cache.add_node(node)
        pending = []
        for pod in self.client.list_pods():
            if assigned(pod):
                self.cache.add_pod(pod)
            elif self.event_handlers.responsible_for(pod):
                pending.append(pod)
        self.queue.add_many(pending)
        self.recorder.start()

    def stop(self) -> None:
        """Stop watching; pods still waiting at Permit are rejected, so no
        binding thread outlives the scheduler."""
        if self._watch_handle is not None:
            self._watch_handle.stop()
            self._watch_handle = None
        self.framework.iterate_waiting_pods(
            lambda wp: wp.reject("", "scheduler stopped"))
        self._bind_pool.shutdown(wait=False)
        self.recorder.stop()

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
        if pod.spec.scheduler_name == self.scheduler_name:
            return self.framework
        return None

    def skip_pod_schedule(self, pod: Pod) -> bool:
        """Deleting, already-assumed and already-bound pods skip."""
        return (pod.metadata.deletion_timestamp is not None
                or self.cache.is_assumed_pod(pod) or assigned(pod))

    # ------------------------------------------------------------------
    # the serial path
    def schedule_one(self, pop_timeout: Optional[float] = None) -> bool:
        """One serial scheduling cycle. False when the queue yielded
        nothing."""
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
        fwk = self.framework
        pod = qpi.pod
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
        fwk = self.framework
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
        pod = qpi.pod
        host = result.suggested_host
        flagged = self.cache.commit_target_flags((host,))
        if flagged:
            reason = commit_target_stale(pod, flagged[host])
            if reason is not None:
                self._reject_stale_commit(qpi, host, reason, cycle)
                return False
        assumed = self._assumed_copy(qpi, host)
        try:
            self.cache.assume_pod(assumed)
        except ValueError as err:
            self._record_failure(qpi, err, "SchedulerError", "", cycle)
            return False
        self.queue.delete_nominated_pod_if_exists(pod)
        fwk = self.framework
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
            status = fwk.run_bind_plugins(state, assumed, host)
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
        fwk = self.framework
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
                                              item[2])
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
        bindable = []
        for (qpi, node, cycle, start), assumed in live:
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
            if not fw.Status.is_ok(status):
                self._unreserve_forget_fail(state, qpi, assumed, node,
                                            status.as_error(), cycle)
                failed += 1
                mutations += 1
                continue
            bindable.append((qpi, node, cycle, start, assumed, state))
        if not bindable:
            return 0, failed, mutations
        t_bind = time.monotonic()
        statuses = fwk.run_bind_plugins_bulk(
            [b[5] for b in bindable], [b[4] for b in bindable],
            [b[1] for b in bindable])
        now = time.monotonic()
        get_tracer().record("bind.bulk", t_bind, now, pods=len(bindable))
        observed = []
        for (qpi, node, cycle, start, assumed, state), status in zip(
                bindable, statuses):
            if not fw.Status.is_ok(status):
                self._unreserve_forget_fail(state, qpi, assumed, node,
                                            status.as_error(), cycle)
                failed += 1
                mutations += 1
                continue
            self.cache.finish_binding(assumed, now)
            fwk.run_post_bind_plugins(state, assumed, node)
            observed.append((qpi, start, node))
        self._observe_bound_bulk(observed, now, observed_from)
        return len(observed), failed, mutations

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
        fwk = self.framework
        t0 = time.monotonic()
        t1 = None
        try:
            status = fwk.wait_on_permit(assumed)
            t1 = time.monotonic()
            if status is None:
                status = fwk.run_pre_bind_plugins(state, assumed, node_name)
            if status is None:
                try:
                    status = fwk.run_bind_plugins(state, assumed, node_name)
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
        m.schedule_attempts.inc("scheduled", self.framework.profile_name,
                                amount=len(observed))
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
            self.recorder.eventf(pod, "Normal", "Scheduled",
                                 "Successfully assigned %s/%s to %s",
                                 pod.namespace, pod.name, node_name)

    def _handle_fit_error(self, state: CycleState, qpi: QueuedPodInfo,
                          fit_err: fw.FitError, cycle: int) -> None:
        """PostFilter (preemption), then record and requeue."""
        nominated_node = ""
        fwk = self.framework
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
        self.framework.run_reserve_plugins_unreserve(state, assumed,
                                                     node_name)
        gang = self.framework.get_plugin("Coscheduling")
        if gang is not None:
            gang.unreserve_group(assumed)
        self._forget_and_fail(qpi, assumed, err, cycle)

    def _reject_stale_commit(self, qpi: QueuedPodInfo, node_name: str,
                             reason: str, cycle: int) -> None:
        """Refuse a placement on a node that died or was cordoned since
        the snapshot; the pod retries on the backoff curve."""
        err = RuntimeError(
            f"commit target node {node_name!r} is {reason} "
            f"(assignment solved against a stale snapshot)")
        self._record_failure(qpi, err, "SchedulerError", "", cycle)

    def _record_failure(self, qpi: QueuedPodInfo, err: Exception,
                        reason: str, nominated_node: str,
                        cycle: int) -> None:
        """Write ``PodScheduled=False`` with ``err`` as its message (and
        the nominated node, if any) on the pod, and requeue it while it
        still exists unassigned: a scheduler error to backoff, a fit
        failure to the unschedulable set."""
        pod = qpi.pod
        self.recorder.event(pod, "Warning", "FailedScheduling", str(err))
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
