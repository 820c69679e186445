"""The batch scheduling loop: drain the queue, solve the batch on the
device, commit. A placed pod is assumed in the cache and bound in the
store; a pod with no feasible node, or placed on a node that died or was
cordoned since the solve's encoding, goes back to the queue as
unschedulable.

Two arms, switched by ``pipeline`` (default: the ``KTPU_PIPELINE``
environment variable, on unless off, 0 or false):

- pipelined: each ``run_batch`` drains batch N+1 (only when the queue
  holds pods, without waiting, while batch N is pending), dispatches its
  solve without waiting for the card, and then commits batch N while the
  card solves. A solved batch is held at most one call, and is committed
  in the same call when the queue has nothing more;
- serialized: drain, solve, commit, one batch per call.

Both arms commit through the same code and bind the same pods to the
same nodes. A batch held while the cache changed under it is discarded
and its pods are solved again from a rebuilt state (the solve already
counted the discarded placements in the device state, in place).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

from kubernetes_tpu_torch.ops.session import SolverSession
from kubernetes_tpu_torch.scheduler.scheduler import (
    Scheduler,
    commit_target_stale,
)
from kubernetes_tpu_torch.scheduler.types import PodInfo

PIPELINE_ENV = "KTPU_PIPELINE"


def pipeline_enabled() -> bool:
    """The ``KTPU_PIPELINE`` switch, on unless set to off, 0 or false."""
    return os.environ.get(PIPELINE_ENV, "on").strip().lower() not in (
        "off", "0", "false")


class BatchScheduler:
    def __init__(self, scheduler: Scheduler, max_batch: int = 4096,
                 device=None, pipeline: Optional[bool] = None,
                 mirror: Optional[bool] = None):
        self.sched = scheduler
        self.max_batch = max_batch
        self.pipeline_enabled = (pipeline_enabled() if pipeline is None
                                 else bool(pipeline))
        self.session = SolverSession(scheduler, device=device, mirror=mirror)
        self.seconds_commit = 0.0
        # most batches in flight at once: a solve dispatched while the
        # previous batch waits for its commit is two
        self.pipeline_depth_max = 0
        self.discards = 0       # held batches dropped and solved again
        self._pending: Optional[dict] = None
        self._cycle_mutations = 0

    def warmup(self, sample_pods: List) -> float:
        """Solve a sample batch once, building and loading the kernels
        (``SolverSession.warm``), and drop the resulting device state.
        Returns the seconds spent."""
        t0 = time.monotonic()
        if sample_pods and self.sched.update_snapshot().list():
            self.session.warm(sample_pods, self.max_batch)
        return time.monotonic() - t0

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
        """Pop up to max_batch pods with the cycle each was popped in.
        Returns (pods popped, the ones to solve)."""
        sched = self.sched
        items, first_cycle = sched.queue.pop_batch(self.max_batch,
                                                   timeout=pop_timeout)
        return len(items), [
            (qpi, first_cycle + i) for i, qpi in enumerate(items)
            if not sched.skip_pod_schedule(qpi.pod)]

    def _run_batch_serialized(self, pop_timeout: Optional[float]) -> int:
        processed, batch = self._drain(pop_timeout)
        self._cycle_mutations = 0
        seq_anchor = self.sched.cache.mutation_seq
        if batch:
            start = time.monotonic()
            assignments, cluster, _ = self.session.solve(
                [q.pod for q, _ in batch], self.max_batch)
            self._commit({"batch": batch, "handle": assignments,
                          "materializer": None, "cluster": cluster,
                          "start": start})
        self.session.note_committed(self._cycle_mutations, seq_anchor)
        return processed

    def _run_batch_pipelined(self, pop_timeout: Optional[float]) -> int:
        sched = self.sched
        prev, self._pending = self._pending, None
        if prev is not None and not self.session.mirror_current():
            # the cache changed while prev was held: its placements are
            # suspect, and the state counts them, in place. Solve its
            # pods again, as the store holds them now, from a rebuild.
            self.session.invalidate()
            self.discards += 1
            batch = []
            for qpi, cycle in prev["batch"]:
                pod = qpi.pod
                live = sched.client.get_pod(pod.namespace, pod.name)
                if live is None or live.uid != pod.uid:
                    continue   # deleted (and maybe recreated) meanwhile
                if live is not pod:
                    qpi.pod_info = PodInfo.of(live)
                batch.append((qpi, cycle))
            processed = len(batch)
            batch = [(qpi, cycle) for qpi, cycle in batch
                     if not sched.skip_pod_schedule(qpi.pod)]
            prev = None
        else:
            # drain only when the queue holds pods; wait for them only
            # when nothing is held
            waiting, _ = sched.queue.pending_hint()
            if prev is not None and waiting == 0:
                processed, batch = 0, []
            else:
                processed, batch = self._drain(
                    0.0 if (prev is not None or waiting) else pop_timeout)

        self._cycle_mutations = 0
        seq_anchor = sched.cache.mutation_seq
        if batch:
            pods = [q.pod for q, _ in batch]
            start = time.monotonic()
            res = self.session.solve(pods, self.max_batch, lazy=True,
                                     incremental_only=prev is not None)
            if res is None:
                # a rebuild must see prev's pods in the snapshot: commit
                # prev first and settle its mutations before re-anchoring
                self._commit(prev)
                self.session.note_committed(self._cycle_mutations,
                                            seq_anchor)
                self._cycle_mutations = 0
                processed += len(prev["batch"])
                prev = None
                seq_anchor = sched.cache.mutation_seq
                res = self.session.solve(pods, self.max_batch, lazy=True)
            handle, cluster, _ = res
            self._pending = {"batch": batch, "handle": handle,
                             "materializer": self.session.last_materializer,
                             "cluster": cluster, "start": start}
            self.pipeline_depth_max = max(self.pipeline_depth_max,
                                          1 + (prev is not None))

        # commit the previous batch while the card solves this one
        if prev is not None:
            self._commit(prev)
            processed += len(prev["batch"])

        # nothing more queued: nothing to overlap, commit now
        if self._pending is not None and sched.queue.num_active() == 0:
            pending, self._pending = self._pending, None
            self._commit(pending)
        self.session.note_committed(self._cycle_mutations, seq_anchor)
        return processed

    def _commit(self, pending: dict) -> int:
        """Materialize and commit one solved batch: refuse placements on
        nodes that died or were cordoned since the encoding, requeue the
        pods with no node, assume and bind the rest. Returns the pods
        committed."""
        sched = self.sched
        mat = pending["materializer"]
        assignments = mat(pending["handle"]) if mat else pending["handle"]
        t0 = time.monotonic()
        batch, cluster = pending["batch"], pending["cluster"]
        assignments = assignments[:len(batch)]
        stale = sched.cache.commit_target_flags(
            {cluster.node_names[a] for a in assignments if a >= 0})
        commits = []
        stale_routed = False
        for (qpi, cycle), a in zip(batch, assignments):
            if a < 0:
                sched.fail_unschedulable(qpi, cycle)
                continue
            node_name = cluster.node_names[a]
            flag = stale.get(node_name, False)
            if flag is not False and \
                    commit_target_stale(qpi.pod, flag) is not None:
                stale_routed = True
                sched.fail_unschedulable(qpi, cycle)
                continue
            commits.append((qpi, node_name, cycle, pending["start"]))
        if stale_routed:
            # the state counts pods on nodes that are gone
            self.session.note_drift()
        committed = 0
        if commits:
            committed, mutations = sched.commit_assignments_bulk(commits)
            self._cycle_mutations += mutations
            if committed < len(commits):
                # the device state counts pods the host refused
                self.session.invalidate()
        self.seconds_commit += time.monotonic() - t0
        return committed
