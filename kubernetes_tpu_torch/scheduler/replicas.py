"""A set of schedulers that schedule at once over one store.

- **Pod-hash sharding** (always): each pending pod belongs to one
  replica's queue, by the crc32 of its uid (its namespace/name when it
  has none), so no two replicas race on a pod.
- **Node-pool sharding** (``shard_nodes``): each replica also caches a
  pool of nodes of its own, by the crc32 of the node's name, and solves
  over that pool only: the replicas cannot conflict on capacity.
- **Shared nodes**: with ``shard_nodes=False`` every replica sees every
  node, and a sibling's binds reach its cache through the watch. The
  capacity guard (``Scheduler.commit_capacity_guard``, set exactly when
  the replicas share nodes) refuses at commit
  a placement whose node a sibling filled since the solve
  (``SchedulerCache.commit_fits``); the pod is requeued and counted
  (``stale_binds_rejected["capacity"]``). In process the replicas share
  one commit lock around that probe and the bind, so two replicas cannot
  both pass a probe on the last room of a node.

In process, ``client_factory(i)`` returns the one shared store. Each
replica with ``use_batch`` attaches a batch path of its own
(``sidecar.attach_batch_scheduler``), with its own solver session on the
card. A remote replica, with a client of its own to a partitioned store,
is not part of this package.
"""

from __future__ import annotations

import threading
import zlib
from dataclasses import dataclass
from typing import Callable, List, Optional

from kubernetes_tpu_torch.config.feature_gates import FeatureGates
from kubernetes_tpu_torch.scheduler.scheduler import Scheduler


def pod_shard_fn(index: int, count: int) -> Callable:
    """Does a pending pod hash to replica ``index`` of ``count``? Keyed
    by uid (stable across requeues), else by namespace/name."""

    def owns(pod) -> bool:
        key = pod.uid or f"{pod.namespace}/{pod.metadata.name}"
        return zlib.crc32(key.encode()) % count == index

    return owns


def node_shard_fn(index: int, count: int) -> Callable[[str], bool]:
    """Is the node named so in replica ``index``'s pool?"""

    def owns(name: str) -> bool:
        return zlib.crc32(name.encode()) % count == index

    return owns


@dataclass
class ReplicaSpec:
    """One replica's place in the set."""

    index: int
    count: int
    shard_nodes: bool = False


def install_replica_sharding(sched: Scheduler, spec: ReplicaSpec
                             ) -> Scheduler:
    """Make ``sched`` replica ``spec.index`` of the set; call it before
    ``start``, so the initial replay is filtered too."""
    sched.replica_name = f"replica-{spec.index}"
    if spec.count > 1:
        sched.pod_shard = pod_shard_fn(spec.index, spec.count)
    if spec.count > 1 and spec.shard_nodes:
        sched.node_shard = node_shard_fn(spec.index, spec.count)
    # the guard matters exactly when replicas share nodes
    sched.commit_capacity_guard = spec.count > 1 and not spec.shard_nodes
    return sched


class SchedulerReplicaSet:
    """``count`` replicas scheduling at once. ``client_factory(i)`` gives
    replica i's client (in process: the shared store). With
    ``use_batch`` each replica has a batch path of its own on ``device``
    (the card unless "cpu"), ``max_batch`` pods a batch, the arms as
    ``pipeline`` says. Each replica has the default component
    configuration (one profile, 16 workers)."""

    def __init__(self, client_factory: Callable[[int], object],
                 count: int = 2, shard_nodes: bool = False,
                 use_batch: bool = False, max_batch: int = 4096,
                 provider: str = "GangSchedulingProvider", device=None,
                 pipeline: Optional[bool] = None):
        from kubernetes_tpu_torch.sidecar import attach_batch_scheduler

        self.replicas: List[Scheduler] = []
        self.batch_schedulers: List[object] = []
        commit_lock = threading.Lock()
        for i in range(count):
            sched = Scheduler.create(
                client_factory(i), provider=provider,
                feature_gates=FeatureGates({"TPUBatchScheduler": use_batch}))
            install_replica_sharding(sched, ReplicaSpec(
                index=i, count=count, shard_nodes=shard_nodes))
            if sched.commit_capacity_guard:
                sched.commit_lock = commit_lock
            if use_batch:
                self.batch_schedulers.append(attach_batch_scheduler(
                    sched, max_batch=max_batch, device=device,
                    pipeline=pipeline))
            self.replicas.append(sched)

    def start(self) -> None:
        for sched in self.replicas:
            sched.start()

    def run(self) -> None:
        for sched in self.replicas:
            sched.run()

    def bound_counts(self) -> List[int]:
        """Pods each replica has bound."""
        return [int(sum(s.metrics.schedule_attempts.get("scheduled", name)
                        for name in s.profiles)) for s in self.replicas]

    def stop(self) -> None:
        for sched in self.replicas:
            sched.stop()
