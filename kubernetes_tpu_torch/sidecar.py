"""The batch scheduling loop: drain the queue, solve the batch on the
device, commit. A placed pod is assumed in the cache and bound in the
store through the framework's Reserve and Bind plugins; a pod Permit
asks to wait (a gang member) stays assumed and binds later on the
scheduler's binding pool, and its assume counts as one of the batch's
own cache mutations, so the carried device state stays valid.

Not every pod goes through the solve, and not every verdict of the solve
is final:

- the partition sends to the serial path
  (``Scheduler.schedule_pod_serial``) a pod the batch path cannot express
  (host ports, inline cloud disks, claims that need per-node binding,
  ``ops.encode.is_host_only``), a pod an extender is interested in, and
  a pod of a profile whose PreFilter, Filter and Score plugins and Score
  weights are not the ones the solve computes (``batchable_profile``: the
  default provider's, or the gang scheduling provider's, under the
  scheduler's feature gates), or whose solve plugins have arguments the
  solve does not read; a Policy's profile, say, one that packs with
  MostAllocated, or one with ``PodTopologySpread.defaultConstraints``, is
  scheduled serially, as its plugins say;
- a placed pod's unbound WaitForFirstConsumer claims (node-independent,
  so the solve ignored them) are bound at commit to a PV of the class's
  free pool, the smallest that fits (``_CommitVolumeBinder``); when the
  pool is dry and the class has no provisioner, the placement is void
  and the pod goes to the serial path;
- a placement on a node that died or was cordoned since the encoding
  goes to the serial path for a fresh verdict, and so does, on a replica
  with the capacity guard (``Scheduler.commit_capacity_guard``), one on
  a node a sibling replica filled since the solve (counted in
  ``capacity_routed``);
- the pods the solve declines go to the serial path when a batch
  declines ``DECLINED_SERIAL_LIMIT`` or fewer, for its exact statuses
  and preemption. Past that (mass decline), each declined pod fails
  with a status built from the node-static masks of its profile: a
  profile no node passes statically fails without PostFilter; runs of
  equally shaped preemptors get a (node, victims) plan each from the
  victim planner, whose victims are evicted in bulk and whose
  preemptors are validated with the real filters and bound in the same
  cycle; the rest run PostFilter with the preemption screen's candidate
  hints.

Two arms, switched by ``pipeline`` (default: the ``KTPU_PIPELINE``
environment variable, on unless off, 0 or false):

- pipelined: each ``run_batch`` drains batch N+1 (only when the queue
  holds pods, without waiting, while batch N is pending), dispatches its
  solve without waiting for the card, and then commits batch N while the
  card solves. A solved batch is held at most one call, and is committed
  in the same call when the queue has nothing more and nothing but the
  batch path's own commits changed the cache since its solve;
- serialized: drain, solve, commit, one batch per call.

Latency-budget batch sizing (``adaptive_chunk``, on by default): a
pod's latency is about one batch cycle, so after each commit the drain
size (``_chunk``) moves one power-of-two bucket down when the cycle's
cost per padded pod times the chunk overruns 70% of
``LATENCY_BUDGET_S``, and up when it would fit twice, between
``MIN_CHUNK`` (never above ``max_batch``) and ``max_batch``. A batch pads
to the smallest warmed bucket that holds it (``_select_pad``); a bucket
the tuner moves to that was never warmed is warmed between cycles
(``SolverSession.warm_pad``, on a copy of the carried state), never
inside a measured one.

Each cycle with work is a ``queue.cycle`` span (drain to commit); each
commit is a ``solve.commit`` span and a ``batch_solve_duration{commit}``
observation; victims of an executed preemption plan get a ``Preempted``
event.

Both arms commit through the same code and bind the same pods to the
same nodes. A batch held while the cache changed under it (a deleted
pod, a preemption's evictions and placements, a serial bind) is
discarded and its pods are solved again from a rebuilt state (the solve
already counted the discarded placements in the device state, in place).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np

from kubernetes_tpu_torch.observability.slo import get_slo_engine
from kubernetes_tpu_torch.observability.tracer import get_tracer
from kubernetes_tpu_torch.ops.encode import is_host_only
from kubernetes_tpu_torch.ops.session import SolverSession
from kubernetes_tpu_torch.scheduler.framework import interface as fw
from kubernetes_tpu_torch.scheduler.framework.cycle_state import CycleState
from kubernetes_tpu_torch.scheduler.framework.plugins.default_preemption import (  # noqa: E501
    pod_eligible_to_preempt_others,
)
from kubernetes_tpu_torch.scheduler.provider import (
    default_plugins,
    gang_scheduling_plugins,
)
from kubernetes_tpu_torch.scheduler.framework.runtime import wiring_of
from kubernetes_tpu_torch.scheduler.preemption_screen import (
    build_screen,
    build_victim_planner,
)
from kubernetes_tpu_torch.scheduler.scheduler import (
    Scheduler,
    commit_target_stale,
)
from kubernetes_tpu_torch.scheduler.types import (
    PodInfo,
    QueuedPodInfo,
    compute_pod_resource_request,
)

PIPELINE_ENV = "KTPU_PIPELINE"

_logger = logging.getLogger(__name__)

# the statuses a mass-declined pod's FitError is built from, per node:
# the node fails one of the pod's node-static predicates, or only the
# resource and topology ones
STATUS_STATIC = fw.Status(
    fw.UNSCHEDULABLE_AND_UNRESOLVABLE,
    "node(s) didn't satisfy the pod's node-static predicates")
STATUS_DYNAMIC = fw.Status(
    fw.UNSCHEDULABLE,
    "node(s) had insufficient resources or violated topology/affinity "
    "constraints")


class _CommitVolumeBinder:
    """Binds the unbound WaitForFirstConsumer claims of a batch's placed
    pods at commit, the batch path's Reserve and PreBind: such a claim's
    class has a pool without node affinity (``wfc_class_batchable``), so
    the solve ignored it and any PV of the pool fits the chosen node.
    Each class's pool is read once per commit, smallest PV first."""

    def __init__(self, client):
        self.client = client
        self._pools: Dict[str, list] = {}
        self.bound = 0

    def _pool(self, sc_name: str) -> list:
        pool = self._pools.get(sc_name)
        if pool is None:
            # a PV with node affinity may have become Available since the
            # drain's verdict: the chosen node may not reach it
            pool = [pv for pv in self.client.list_pvs()
                    if pv.phase == "Available" and pv.claim_ref is None
                    and pv.storage_class_name == sc_name
                    and pv.node_affinity is None]

            def cap_key(pv):
                cap = pv.capacity.get("storage")
                return (cap is None, 0 if cap is None else cap.value())

            pool.sort(key=cap_key)
            self._pools[sc_name] = pool
        return pool

    def finalize(self, pod) -> bool:
        """Bind every unbound claim of the pod. False when a pool ran dry
        and the class has no provisioner, or a bind failed: the placement
        is void, and the pod's binds made here are undone."""
        done: List[tuple] = []  # (PV name, claim name) bound for this pod
        for v in pod.spec.volumes:
            if not v.persistent_volume_claim:
                continue
            pvc = self.client.get_pvc(pod.namespace,
                                      v.persistent_volume_claim)
            if pvc is None or pvc.volume_name:
                continue
            sc_name = pvc.storage_class_name or ""
            pool = self._pool(sc_name)
            request = pvc.requests.get("storage")
            chosen = None
            for i, pv in enumerate(pool):
                if pvc.access_modes and not \
                        set(pvc.access_modes) <= set(pv.access_modes):
                    continue
                cap = pv.capacity.get("storage")
                if request is not None and (cap is None or cap < request):
                    continue
                chosen = i
                break
            if chosen is not None:
                pv = pool.pop(chosen)
                if not self.client.bind_pv(pv.name, pod.namespace,
                                           pvc.name):
                    self._rollback(pod, done)
                    return False
                done.append((pv.name, pvc.name))
                self.bound += 1
                continue
            sc = self.client.get_storage_class(sc_name) if sc_name else None
            if sc is None or not sc.provisioner:
                self._rollback(pod, done)
                return False
            # dynamic provisioning serves the claim on any node
        return True

    def _rollback(self, pod, done: List[tuple]) -> None:
        for pv_name, pvc_name in done:
            if not self.client.unbind_pv(pv_name, pod.namespace, pvc_name):
                _logger.error("PV bind rollback failed: %s", pv_name)
        self.bound -= len(done)


# plugins whose arguments the batch path honours, because it runs the
# plugin itself: Coscheduling's set its Permit wait and its gang backoff
ARGS_THE_BATCH_PATH_RUNS = frozenset({"Coscheduling"})


def _solve_key(wiring) -> tuple:
    """What the solve computes of a wiring: its PreFilter and Filter
    plugins and its Score plugins with their weights."""
    return (sorted(name for name, _ in wiring.get("pre_filter", ())),
            sorted(name for name, _ in wiring.get("filter", ())),
            sorted(wiring.get("score", ())))


def batchable_profile(fwk, feature_gates=None) -> bool:
    """The profile's pods may take the batch path: its PreFilter, Filter
    and Score plugins and its Score weights are those of the default
    provider or of the gang scheduling provider (which differs only at
    QueueSort, PreFilter and Permit), which the solve computes, and none
    of its PreFilter, Filter, PreScore and Score plugins has arguments
    (the solve computes each plugin with its defaults), bar those in
    ``ARGS_THE_BATCH_PATH_RUNS``."""
    wiring = fwk.wiring()
    if any(fwk.plugin_args.get(name)
           for point in ("pre_filter", "filter", "pre_score", "score")
           for name, _ in wiring.get(point, ())
           if name not in ARGS_THE_BATCH_PATH_RUNS):
        return False
    key = _solve_key(wiring)
    return any(key == _solve_key(wiring_of(provider(feature_gates)))
               for provider in (default_plugins, gang_scheduling_plugins))


def pipeline_enabled() -> bool:
    """The ``KTPU_PIPELINE`` switch, on unless set to off, 0 or false."""
    return os.environ.get(PIPELINE_ENV, "on").strip().lower() not in (
        "off", "0", "false")


class BatchScheduler:
    # declined pods a batch sends to the serial path; past it, mass decline
    DECLINED_SERIAL_LIMIT = 32
    # seconds a batch cycle (solve to commit) may take: the drain size
    # adapts to keep a pod's latency, about one cycle, under it
    LATENCY_BUDGET_S = 1.5
    MIN_CHUNK = 512

    def __init__(self, scheduler: Scheduler, max_batch: int = 4096,
                 device=None, pipeline: Optional[bool] = None,
                 mirror: Optional[bool] = None, validate: bool = False,
                 adaptive_chunk: bool = True, backend=None):
        self.sched = scheduler
        self.max_batch = max_batch
        self.pipeline_enabled = (pipeline_enabled() if pipeline is None
                                 else bool(pipeline))
        # profile name -> whether its pods may take the batch path
        self.batchable_profiles = {
            name: batchable_profile(fwk, scheduler.feature_gates)
            for name, fwk in scheduler.profiles.items()}
        # placements the capacity guard sent to the serial path
        self.capacity_routed = 0
        # False pins the drain and pad size at max_batch
        self.adaptive_chunk = adaptive_chunk
        self._chunk = max_batch
        # pad sizes whose shapes are warmed, the shrink waiting for its
        # warm, and pods of a recent batch to warm it with
        self._warmed_pads: set = set()
        self._need_warm_pad: Optional[int] = None
        self._warm_samples: List = []
        # re-check every placement with the host's filters before binding
        self.validate = validate
        # ``backend`` overrides the session's default (the sharded tier's
        # ``ShardedBackend``, say)
        self.session = SolverSession(scheduler, device=device, mirror=mirror,
                                     backend=backend)
        self.seconds_commit = 0.0
        # host seconds of the paths behind the solve: the preemption
        # screen and victim planner builds, plan execution (evictions,
        # validation, bulk bind), the failed statuses and PostFilter of
        # mass-declined pods, the serial path, and the commit-time binds
        # of WaitForFirstConsumer claims (inside the commit's seconds);
        # and the drains that popped pods (the queue's sort included)
        self.seconds = {"screen": 0.0, "plan": 0.0, "execute": 0.0,
                        "fail": 0.0, "serial": 0.0, "volumes": 0.0,
                        "drain": 0.0}
        self.preempted = 0      # victims evicted by executed plans
        self.planned = 0        # preemptors bound by executed plans
        self.volumes_bound = 0  # claims bound at commit
        # most batches in flight at once: a solve dispatched while the
        # previous batch waits for its commit is two
        self.pipeline_depth_max = 0
        self.discards = 0       # held batches dropped and solved again
        self._pending: Optional[dict] = None
        self._cycle_mutations = 0
        # the schedule-latency SLO reads this scheduler's e2e histogram
        get_slo_engine().add_registry(scheduler.metrics.registry)

    def warmup(self, sample_pods: List) -> float:
        """Solve a sample batch, building and loading the kernels
        (``SolverSession.warm``), and drop the resulting device state;
        settle the chunk on the timed second solve's cost, and warm the
        settled chunk and the bucket below it, so the tuner's first
        shrink needs no warm. Host-only samples are left out. Returns the
        seconds spent."""
        t0 = time.monotonic()
        cache: dict = {}
        sample_pods = [p for p in sample_pods
                       if not is_host_only(p, self.sched.client, cache)]
        if not (sample_pods and self.sched.update_snapshot().list()):
            return time.monotonic() - t0
        est = self.session.warm(sample_pods, self.max_batch)
        self._warmed_pads.add(self.max_batch)
        self._warm_samples = list(sample_pods[:8])
        per_pod = est / self.max_batch
        prev = None
        while prev != self._chunk:
            prev = self._chunk
            self._tune_chunk(self._chunk, per_pod * self._chunk)
        self._need_warm_pad = None
        half = max(self.MIN_CHUNK, self._chunk // 2)
        for pad in (self._chunk, half):
            if pad <= self._chunk and pad not in self._warmed_pads and \
                    self.session.warm_pad(sample_pods, pad) is not None:
                self._warmed_pads.add(pad)
        return time.monotonic() - t0

    def _tune_chunk(self, padded_pods: int, cycle_seconds: float) -> None:
        """After a committed batch: the cost per padded pod times the
        chunk must stay under 70% of the budget. One power-of-two bucket
        a batch in either direction; a bucket not warmed yet is warmed
        before the next cycle."""
        if not self.adaptive_chunk:
            return
        if padded_pods <= 0 or cycle_seconds <= 0:
            return
        per_pod = cycle_seconds / padded_pods
        target = int(0.7 * self.LATENCY_BUDGET_S / max(per_pod, 1e-9))
        if target < self._chunk and self._chunk > self.MIN_CHUNK:
            new = self._chunk // 2
        elif target >= 2 * self._chunk and self._chunk < self.max_batch:
            new = self._chunk * 2
        else:
            return
        self._chunk = min(self.max_batch, max(self.MIN_CHUNK, new))
        if self._chunk not in self._warmed_pads:
            self._need_warm_pad = self._chunk

    def _select_pad(self, n_batch: int) -> int:
        """The smallest warmed bucket that holds ``n_batch`` pods, below
        the chunk; else the chunk."""
        pad = self._chunk
        for b in sorted(self._warmed_pads):
            if n_batch <= b < pad:
                return b
        return pad

    def _service_warm_pad(self) -> None:
        """Warm the bucket the tuner moved to, between cycles (on a copy
        of the carried state: a held batch stays good)."""
        if self._need_warm_pad is None:
            return
        pad = self._need_warm_pad
        self._need_warm_pad = None
        if pad not in self._warmed_pads and self._warm_samples and \
                self.session.warm_pad(self._warm_samples, pad) is not None:
            self._warmed_pads.add(pad)

    def _solve_started(self, batchable, pad: int) -> None:
        """The pad's shape is live and these pods are samples for later
        pad warms."""
        self._warmed_pads.add(pad)
        self._warm_samples = [q.pod for q, _ in batchable[:8]]

    def _trace_cycle(self, start: float, processed: int,
                     committed: int) -> None:
        """A ``queue.cycle`` span from the drain to the commit: it covers
        the gaps between a pod's own spans and the solve spans (the
        lowest priority in critical-path attribution). Idle cycles record
        nothing."""
        if processed == 0 and committed == 0:
            return
        tracer = get_tracer()
        if tracer.enabled:
            tracer.record("queue.cycle", start, time.monotonic(),
                          pods=processed, committed=committed)

    def run_batch(self, pop_timeout: Optional[float] = 0.2) -> int:
        """One cycle of the active arm. Returns the pods worked on."""
        if self.pipeline_enabled:
            return self._run_batch_pipelined(pop_timeout)
        return self._run_batch_serialized(pop_timeout)

    def flush(self, timeout: float = 60.0) -> int:
        """Commit a held batch, so no popped pod is stranded when the
        caller stops pumping. Returns the pods worked on."""
        total = 0
        deadline = time.monotonic() + timeout
        while self._pending is not None and time.monotonic() < deadline:
            total += self.run_batch(pop_timeout=0.0)
        return total

    @property
    def holding(self) -> bool:
        """A solved batch waits for its commit."""
        return self._pending is not None

    def pipeline_info(self) -> Optional[Dict]:
        """The pipelined arm's depth and discards; None when the arm is
        off or never dispatched a batch."""
        if not self.pipeline_enabled or self.pipeline_depth_max == 0:
            return None
        return {"depth": self.pipeline_depth_max, "discards": self.discards}

    def mirror_info(self) -> Optional[Dict]:
        """The device mirror's counters; None when it is off."""
        mirror = self.session.mirror
        return None if mirror is None else mirror.info()

    # ------------------------------------------------------------------
    def _drain(self, pop_timeout: Optional[float]):
        """Pop up to the chunk's pods, each with the cycle it was popped
        in."""
        t0 = time.monotonic()
        items, first_cycle = self.sched.queue.pop_batch(self._chunk,
                                                        timeout=pop_timeout)
        if items:
            self.seconds["drain"] += time.monotonic() - t0
        return [(qpi, first_cycle + i) for i, qpi in enumerate(items)]

    def _partition(self, qpis):
        """(batchable (qpi, cycle) pairs, serial qpis); pods to skip and
        pods of profiles this scheduler does not run drop out; pods of a
        profile the solve does not compute, pods an extender is
        interested in and host-only pods go serial. One scan of each
        storage class's pool per drain."""
        sched = self.sched
        extenders = sched.extenders
        batchable, serial = [], []
        host_only_cache: dict = {}
        for qpi, cycle in qpis:
            pod = qpi.pod
            fwk = sched.framework_for_pod(pod)
            if fwk is None or sched.skip_pod_schedule(pod):
                continue
            if (not self.batchable_profiles[fwk.profile_name]
                    or any(e.is_interested(pod) for e in extenders)
                    or is_host_only(pod, sched.client, host_only_cache)):
                serial.append(qpi)
            else:
                batchable.append((qpi, cycle))
        return batchable, serial

    def _run_serial(self, serial: List[QueuedPodInfo]) -> None:
        sched = self.sched
        if sched.stopped:
            return
        t0 = time.monotonic()
        seen = set()
        for qpi in serial:
            if qpi.pod.full_name() in seen:
                continue
            seen.add(qpi.pod.full_name())
            # a batch commit may already have assumed it
            if sched.skip_pod_schedule(qpi.pod):
                continue
            sched.schedule_pod_serial(qpi)
        self.seconds["serial"] += time.monotonic() - t0

    def _solved(self, batchable, handle, materializer, cluster,
                start: float, pad: int,
                observed_from: Optional[float] = None) -> dict:
        """A solved batch with what its commit needs from this solve,
        captured now: the session's fields may describe a later batch by
        the time this one commits."""
        session = self.session
        return {"batch": batchable, "handle": handle,
                "materializer": materializer, "cluster": cluster,
                "profiles": session.last_profile_idx,
                "inexpressible": session.last_inexpressible,
                "masks": session.static_masks_host, "start": start,
                "pad": pad, "observed_from": observed_from}

    def _run_batch_serialized(self, pop_timeout: Optional[float]) -> int:
        t_cycle = time.monotonic()
        self._service_warm_pad()
        qpis = self._drain(pop_timeout)
        batchable, serial = self._partition(qpis)
        self._cycle_mutations = 0
        seq_anchor = self.sched.cache.mutation_seq
        committed = 0
        if batchable:
            pad = self._select_pad(len(batchable))
            self.session.trace_cycle = batchable[0][1]
            start = time.monotonic()
            assignments, cluster, _ = self.session.solve(
                [q.pod for q, _ in batchable], pad)
            self._solve_started(batchable, pad)
            committed = self._commit(self._solved(
                batchable, assignments, None, cluster, start, pad), serial)
        self._run_serial(serial)
        self.session.note_committed(self._cycle_mutations, seq_anchor)
        self._trace_cycle(t_cycle, len(qpis), committed)
        return len(qpis)

    def _run_batch_pipelined(self, pop_timeout: Optional[float]) -> int:
        sched = self.sched
        t_cycle = time.monotonic()
        prev, self._pending = self._pending, None
        self._service_warm_pad()
        if prev is not None and not self.session.mirror_current():
            # the cache changed while prev was held: its placements are
            # suspect, and the state counts them, in place. Solve its
            # pods again, as the store holds them now, from a rebuild.
            self.session.invalidate()
            self.discards += 1
            qpis = []
            for qpi, cycle in prev["batch"]:
                pod = qpi.pod
                live = sched.client.get_pod(pod.namespace, pod.name)
                if live is None or live.uid != pod.uid:
                    continue   # deleted (and maybe recreated) meanwhile
                if live is not pod:
                    qpi.pod_info = PodInfo.of(live)
                qpis.append((qpi, cycle))
            prev = None
        else:
            # drain only when the queue holds pods; wait for them only
            # when nothing is held
            waiting, _ = sched.queue.pending_hint()
            if prev is not None and waiting == 0:
                qpis = []
            else:
                qpis = self._drain(
                    0.0 if (prev is not None or waiting) else pop_timeout)
        processed = len(qpis)
        batchable, serial = self._partition(qpis)

        self._cycle_mutations = 0
        seq_anchor = sched.cache.mutation_seq
        committed = 0
        if batchable:
            pods = [q.pod for q, _ in batchable]
            # sized from the batchable pods, not the drain
            pad = self._select_pad(len(batchable))
            self.session.trace_cycle = batchable[0][1]
            start = time.monotonic()
            res = self.session.solve(pods, pad, lazy=True,
                                     incremental_only=prev is not None)
            if res is None:
                # a rebuild must see prev's pods in the snapshot: commit
                # prev first and settle its mutations before re-anchoring
                committed += self._commit(prev, serial)
                self.session.note_committed(self._cycle_mutations,
                                            seq_anchor)
                self._cycle_mutations = 0
                processed += len(prev["batch"])
                prev = None
                seq_anchor = sched.cache.mutation_seq
                res = self.session.solve(pods, pad, lazy=True)
            handle, cluster, _ = res
            self._solve_started(batchable, pad)
            # the e2e histogram and the pods' spans from here, as the
            # JAX package's: the solve's own spans attribute the time
            # before the dispatch returned
            self._pending = self._solved(batchable, handle,
                                         self.session.last_materializer,
                                         cluster, start, pad,
                                         observed_from=time.monotonic())
            self.pipeline_depth_max = max(self.pipeline_depth_max,
                                          1 + (prev is not None))

        # commit the previous batch while the card solves this one
        if prev is not None:
            committed += self._commit(prev, serial)
            processed += len(prev["batch"])

        # nothing more queued: nothing to overlap, commit now, unless
        # something besides the batch path's own commits (a preemption's
        # evictions and placements) changed the cache since the solve:
        # then the batch stays held, and the next cycle discards it
        if (self._pending is not None and sched.queue.num_active() == 0
                and sched.cache.mutation_seq
                == seq_anchor + self._cycle_mutations):
            pending, self._pending = self._pending, None
            committed += self._commit(pending, serial)
        self._run_serial(serial)
        self.session.note_committed(self._cycle_mutations, seq_anchor)
        self._trace_cycle(t_cycle, processed, committed)
        return processed

    # ------------------------------------------------------------------
    def _commit(self, pending: dict, serial: List[QueuedPodInfo]) -> int:
        """Materialize and commit one solved batch: route placements on
        nodes that died or were cordoned since the encoding to the serial
        path, assume and bind the rest, and route or fail the declined
        pods. Returns the pods committed."""
        sched = self.sched
        mat = pending["materializer"]
        assignments = mat(pending["handle"]) if mat else pending["handle"]
        if sched.stopped:
            # a stopped scheduler binds nothing; the state counts this
            # batch's placements
            self.session.invalidate()
            return 0
        t0 = time.monotonic()
        batch, cluster = pending["batch"], pending["cluster"]
        assignments = assignments[:len(batch)]
        stale = sched.cache.commit_target_flags(
            {cluster.node_names[a] for a in assignments if a >= 0})
        # a replica sharing its nodes: one cumulative probe for the batch;
        # a target a sibling filled since the solve goes to the serial
        # path, which places the pod against the cache as it is now
        fits = None
        if sched.commit_capacity_guard:
            fits = sched.cache.commit_fits(
                [(qpi.pod, cluster.node_names[a] if a >= 0 else "")
                 for (qpi, _), a in zip(batch, assignments)])
        commits, declined = [], []
        vol_binder = _CommitVolumeBinder(sched.client)
        stale_routed = False
        capacity_routed = 0
        for bi, ((qpi, cycle), a) in enumerate(zip(batch, assignments)):
            if a < 0:
                declined.append((bi, qpi, cycle))
                continue
            node_name = cluster.node_names[a]
            flag = stale.get(node_name, False)
            if flag is not False and \
                    commit_target_stale(qpi.pod, flag) is not None:
                stale_routed = True
                serial.append(qpi)
                continue
            if fits is not None and fits[bi] is not None:
                capacity_routed += 1
                serial.append(qpi)
                continue
            if self.validate and not self._host_validates(qpi, node_name):
                # the device state counts a pod the host refused
                self.session.invalidate()
                serial.append(qpi)
                continue
            t1 = time.monotonic()
            finalized = vol_binder.finalize(qpi.pod)
            self.seconds["volumes"] += time.monotonic() - t1
            if not finalized:
                # no PV for a claim: the serial path gives the pod its
                # status, and the device state counts a void placement
                self.session.invalidate()
                serial.append(qpi)
                continue
            commits.append((qpi, node_name, cycle, pending["start"]))
        self.volumes_bound += vol_binder.bound
        if stale_routed:
            # the state counts pods on nodes that are gone
            self.session.note_drift()
        if capacity_routed:
            self.capacity_routed += capacity_routed
            sched.note_stale_binds("capacity", capacity_routed)
            # siblings' binds changed the state under the solve
            self.session.invalidate()
        committed = 0
        if commits:
            # pods parked at Permit count as mutations through their
            # assumes, and bind later on the binding pool
            committed, failed, mutations = sched.commit_assignments_bulk(
                commits, observed_from=pending["observed_from"])
            self._cycle_mutations += mutations
            if failed:
                # the device state counts pods the host refused
                self.session.invalidate()
        self.seconds_commit += time.monotonic() - t0
        if len(declined) <= self.DECLINED_SERIAL_LIMIT:
            serial.extend(qpi for _, qpi, _ in declined)
        else:
            committed += self._mass_decline(pending, declined, serial)
        now = time.monotonic()
        sched.metrics.batch_solve_duration.observe(now - t0, "commit")
        tracer = get_tracer()
        if tracer.enabled:
            tracer.record("solve.commit", t0, now, pods=len(batch),
                          committed=committed,
                          cycle=batch[0][1] if batch else -1,
                          pad=pending["pad"])
        self._tune_chunk(pending["pad"], now - pending["start"])
        return committed

    def _mass_decline(self, pending: dict, declined: List[tuple],
                      serial: List[QueuedPodInfo]) -> int:
        """Past ``DECLINED_SERIAL_LIMIT`` declines: plan and execute the
        preemptions of equally shaped preemptors, and fail the rest with
        statuses built once per profile from the static masks (PostFilter
        with the screen's hints where preemption can help). Returns the
        preemptors bound."""
        sched = self.sched
        cluster = pending["cluster"]
        profiles, masks = pending["profiles"], pending["masks"]
        inexpressible = pending["inexpressible"]
        screen = planner = None
        t0 = time.monotonic()
        if any(q.pod.priority() > 0 and sched.framework_for_pod(
                q.pod).has_post_filter_plugins() for _, q, _ in declined):
            snapshot = sched.update_snapshot()
            screen = build_screen(snapshot)
            t1 = time.monotonic()
            self.seconds["screen"] += t1 - t0
            planner = build_victim_planner(snapshot,
                                           pdbs=sched.client.list_pdbs())
            self.seconds["plan"] += time.monotonic() - t1
        screen_masks: dict = {}

        def screen_mask(bi: int):
            """Pod ``bi``'s static mask in the screen's node order (the
            encoder's order may differ); one per profile."""
            if profiles is None or masks is None or bi >= len(profiles):
                return None
            ui = int(profiles[bi])
            if ui not in screen_masks:
                if ui >= len(masks):
                    screen_masks[ui] = None
                else:
                    by_name = dict(zip(cluster.node_names, masks[ui]))
                    screen_masks[ui] = np.array(
                        [bool(by_name.get(name, False))
                         for name in screen.node_names], dtype=bool)
            return screen_masks[ui]

        # runs of equally shaped preemptors (priority, requests, static
        # profile) are planned together; the rest fail with statuses
        t0 = time.monotonic()
        groups: dict = {}
        rest: List[tuple] = []
        for bi, qpi, cycle in declined:
            if inexpressible is not None and bi < len(inexpressible) \
                    and inexpressible[bi]:
                serial.append(qpi)
                continue
            if planner is not None and qpi.pod.priority() > 0 and \
                    pod_eligible_to_preempt_others(qpi.pod, sched.snapshot):
                req = compute_pod_resource_request(qpi.pod)
                ui = int(profiles[bi]) if profiles is not None and \
                    bi < len(profiles) else -1
                key = (qpi.pod.priority(), req.milli_cpu, req.memory, ui)
                groups.setdefault(key, []).append((bi, qpi, cycle))
            else:
                rest.append((bi, qpi, cycle))
        plans: List[tuple] = []   # (qpi, cycle, node name, victims)
        for members in groups.values():
            got = planner.plan_group(members[0][1].pod, len(members),
                                     static_mask=screen_mask(members[0][0]))
            for (bi, qpi, cycle), (node_name, victims) in zip(members, got):
                plans.append((qpi, cycle, node_name, victims))
            rest.extend(members[len(got):])
        self.seconds["plan"] += time.monotonic() - t0

        t0 = time.monotonic()
        statuses_by_profile: dict = {}
        with sched.client.batched_status_writes():
            for bi, qpi, cycle in rest:
                hints = None
                if screen is not None and qpi.pod.priority() > 0:
                    # rotated by position, so a uniform batch spreads
                    # over distinct candidates
                    hints = screen.candidates_for(
                        qpi.pod, static_mask=screen_mask(bi), rotation=bi)
                if not self._fail_declined(qpi, cycle, cluster, bi,
                                           profiles, masks,
                                           statuses_by_profile, hints):
                    serial.append(qpi)
        self.seconds["fail"] += time.monotonic() - t0
        if not plans:
            return 0
        t0 = time.monotonic()
        committed = self._execute_preemption_plans(plans, pending["start"],
                                                   serial)
        self.seconds["execute"] += time.monotonic() - t0
        return committed

    def _execute_preemption_plans(self, plans: List[tuple], start: float,
                                  serial: List[QueuedPodInfo]) -> int:
        """Evict every plan's victims in one store call (a ``Preempted``
        event each), refresh the
        snapshot, validate each preemptor on its planned node with the
        real filters (on clones carrying the batch's earlier placements)
        and bind the validated ones in bulk; a preemptor that fails
        validation goes to the serial path. Lower-priority pods nominated
        to a node a preemptor took lose the nomination. Returns the
        preemptors bound."""
        sched = self.sched
        doomed = []
        for qpi, _cycle, node_name, victims in plans:
            fwk = sched.framework_for_pod(qpi.pod)
            recorder = fwk.event_recorder
            for victim in victims:
                if any(f.reject_waiting_pod(victim.uid)
                       for f in sched.profiles.values()):
                    continue
                doomed.append((victim.namespace, victim.name))
                if recorder is not None:
                    recorder.event(
                        victim, "Normal", "Preempted",
                        f"Preempted by {qpi.pod.namespace}/"
                        f"{qpi.pod.metadata.name} on node {node_name}")
        if doomed:
            sched.client.delete_pods(doomed)
            self.preempted += len(doomed)
        snapshot = sched.update_snapshot()
        clones: dict = {}
        commits = []
        for qpi, cycle, node_name, _victims in plans:
            ni = clones.get(node_name)
            if ni is None:
                base = snapshot.get(node_name)
                if base is None or base.node is None:
                    serial.append(qpi)
                    continue
                ni = clones[node_name] = base.clone()
            fwk = sched.framework_for_pod(qpi.pod)
            state = CycleState()
            ok = fw.Status.is_ok(fwk.run_pre_filter_plugins(state, qpi.pod))
            if ok:
                ok = fw.Status.is_ok(fwk.run_filter_plugins_with_nominated_pods(
                    state, qpi.pod, ni))
            if not ok:
                # the resource model said yes, the filters said no
                serial.append(qpi)
                continue
            ni.add_pod(qpi.pod)
            commits.append((qpi, node_name, cycle, start))
        committed = 0
        if commits:
            # host placements: the device state does not count them, so
            # they are not the batch's own mutations (the mirror scatters
            # them, or the session rebuilds)
            committed, _, _ = sched.commit_assignments_bulk(commits,
                                                            solved=False)
            self.planned += committed
        max_prio_by_node: dict = {}
        for qpi, _cycle, node_name, _victims in plans:
            prio = qpi.pod.priority()
            if prio > max_prio_by_node.get(node_name, prio - 1):
                max_prio_by_node[node_name] = prio
        nominator = sched.queue
        for node_name, prio in max_prio_by_node.items():
            for pi in nominator.nominated_pods_for_node(node_name):
                if pi.pod.priority() < prio:
                    nominator.delete_nominated_pod_if_exists(pi.pod)
                    sched.client.clear_nominated_node_name(pi.pod.namespace,
                                                           pi.pod.name)
        return committed

    def _fail_declined(self, qpi: QueuedPodInfo, cycle: int, cluster,
                       batch_index: int, profiles, masks,
                       statuses_by_profile: dict,
                       candidate_hints=None) -> bool:
        """Mark a declined pod unschedulable without the serial path:
        per node, ``STATUS_STATIC`` where the node fails the pod's
        profile's static mask, else ``STATUS_DYNAMIC``; the statuses, the
        message and whether every node failed statically are built once
        per profile. False when the batch's static context is missing
        (the caller then uses the serial path)."""
        if profiles is None or batch_index >= len(profiles):
            return False
        ui = int(profiles[batch_index])
        cached = statuses_by_profile.get(ui)
        if cached is None:
            if masks is None or ui >= len(masks):
                return False
            mask = masks[ui][:cluster.num_real_nodes]
            statuses = {name: (STATUS_DYNAMIC if ok else STATUS_STATIC)
                        for name, ok in zip(cluster.node_names, mask)}
            probe = fw.FitError(num_all_nodes=cluster.num_real_nodes,
                                filtered_nodes_statuses=statuses)
            cached = (statuses, str(probe), not bool(mask.any()))
            statuses_by_profile[ui] = cached
        statuses, message, all_static = cached
        fit_err = fw.FitError(pod=qpi.pod,
                              num_all_nodes=cluster.num_real_nodes,
                              filtered_nodes_statuses=statuses,
                              message=message)
        # every node failed a node-static predicate: preemption cannot
        # help, so PostFilter does not run
        self.sched.fail_unschedulable(qpi, fit_err, cycle,
                                      candidate_hints=candidate_hints,
                                      run_post_filter=not all_static)
        return True

    def _host_validates(self, qpi: QueuedPodInfo, node_name: str) -> bool:
        """The host's PreFilter and Filter accept ``node_name`` for the
        pod, on a snapshot that includes this batch's earlier commits."""
        sched = self.sched
        fwk = sched.framework_for_pod(qpi.pod)
        snapshot = sched.update_snapshot()
        state = CycleState()
        if not fw.Status.is_ok(fwk.run_pre_filter_plugins(state, qpi.pod)):
            return False
        ni = snapshot.get(node_name)
        if ni is None:
            return False
        return fw.Status.is_ok(fwk.run_filter_plugins_with_nominated_pods(
            state, qpi.pod, ni))


def attach_batch_scheduler(sched: Scheduler, max_batch: int = 4096,
                           device=None, pipeline: Optional[bool] = None,
                           mirror: Optional[bool] = None,
                           validate: bool = False,
                           adaptive_chunk: bool = True,
                           backend=None) -> Optional[BatchScheduler]:
    """Install the batch path on ``sched`` (``sched.run`` then drives its
    cycles) when the ``TPUBatchScheduler`` feature gate is on; None, and
    the serial path alone, when it is off. The other arguments are
    ``BatchScheduler``'s."""
    if not sched.feature_gates.enabled("TPUBatchScheduler"):
        return None
    bs = BatchScheduler(sched, max_batch=max_batch, device=device,
                        pipeline=pipeline, mirror=mirror, validate=validate,
                        adaptive_chunk=adaptive_chunk, backend=backend)
    sched.batch_scheduler = bs
    return bs
