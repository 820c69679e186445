"""A set of schedulers that schedule at once over one store.

- **Pod-hash sharding** (``shard_pods``, the default): each pending pod
  belongs to one replica's queue, by the crc32 of its uid (its
  namespace/name when it has none), so no two replicas race on a pod.
  ``shard_pods=False`` makes every replica race on every pod (the
  conflict cell).
- **Node-pool sharding** (``shard_nodes``): each replica also caches a
  pool of nodes of its own, by the crc32 of the node's name, and solves
  over that pool only: the replicas cannot conflict on capacity.
- **Shared nodes**: with ``shard_nodes=False`` every replica sees every
  node, and a sibling's binds reach its cache through the watch. Two
  guards settle the races:
  - the cache half, ``Scheduler.commit_capacity_guard`` (on exactly
    when the replicas share nodes): a placement whose node a sibling
    filled since the solve is refused at commit
    (``SchedulerCache.commit_fits``), requeued and counted as
    ``stale_binds_rejected["capacity"]``;
  - the store half: a ``PartitionedStore(capacity_guard=True)`` keeps a
    bind-time ledger of each node's capacity and refuses the bind that
    would overfill it (``CapacityConflictError``, counted as
    ``"bind_conflict"``); the same-pod bind check refuses a pod a
    sibling bound first (``"replica_conflict"``). The loser unreserves,
    forgets and requeues.
  Over a client with no ledger (a bare ``ClusterStore``, a
  ``PartitionedStore`` without ``capacity_guard``, a REST client) the
  replicas hold one commit lock from the cache probe to the bind
  instead. Where the watch delivers a bind before the bind returns (a
  store with synchronous dispatch) two replicas then cannot both pass
  a probe on the last room of a node; over an asynchronous watch the
  lock narrows that race and only the ledger closes it.

``client_factory(i)`` gives replica i's client: in process the shared
store (bare or partitioned), over REST a partition-aware client of its
own (``RestClusterClient(partition_urls=...)``). Each replica with
``use_batch`` attaches a batch path of its own
(``sidecar.attach_batch_scheduler``), with its own solver session on the
card.
"""

from __future__ import annotations

import threading
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

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
    """One replica's place in the set. ``shard_pods=False`` makes every
    replica responsible for every pod."""

    index: int
    count: int
    shard_pods: bool = True
    shard_nodes: bool = False


def install_replica_sharding(sched: Scheduler, spec: ReplicaSpec
                             ) -> Scheduler:
    """Make ``sched`` replica ``spec.index`` of the set; call it before
    ``start``, so the initial replay is filtered too."""
    sched.replica_name = f"replica-{spec.index}"
    if spec.count > 1 and spec.shard_pods:
        sched.pod_shard = pod_shard_fn(spec.index, spec.count)
    if spec.count > 1 and spec.shard_nodes:
        sched.node_shard = node_shard_fn(spec.index, spec.count)
    # the guard matters exactly when replicas share nodes
    sched.commit_capacity_guard = spec.count > 1 and not spec.shard_nodes
    return sched


class SchedulerReplicaSet:
    """``count`` replicas scheduling at once. ``client_factory(i)`` gives
    replica i's client; ``event_client_factory(i)`` (default: the same
    client) the one its events go through. With ``use_batch`` each
    replica has a batch path of its own on ``device`` (the card unless
    "cpu"), ``max_batch`` pods a batch, the arms as ``pipeline`` says.
    Each replica has the default component configuration (one profile,
    16 workers)."""

    def __init__(self, client_factory: Callable[[int], object],
                 count: int = 2, shard_pods: bool = True,
                 shard_nodes: bool = False,
                 use_batch: bool = False, max_batch: int = 4096,
                 provider: str = "GangSchedulingProvider", device=None,
                 pipeline: Optional[bool] = None,
                 event_client_factory: Optional[Callable] = None):
        from kubernetes_tpu_torch.sidecar import attach_batch_scheduler

        self.replicas: List[Scheduler] = []
        self.batch_schedulers: List[object] = []
        commit_lock = threading.Lock()
        for i in range(count):
            client = client_factory(i)
            sched = Scheduler.create(
                client, provider=provider,
                feature_gates=FeatureGates({"TPUBatchScheduler": use_batch}),
                event_client=event_client_factory(i)
                if event_client_factory else None)
            install_replica_sharding(sched, ReplicaSpec(
                index=i, count=count, shard_pods=shard_pods,
                shard_nodes=shard_nodes))
            if sched.commit_capacity_guard and \
                    getattr(client, "ledger", None) is None:
                # no bind-time ledger settles a node race: the replicas
                # serialize from the cache probe to the bind instead
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

    def pending_count(self) -> int:
        """Pods waiting in the replicas' active queues."""
        return sum(s.queue.pending_active_count() for s in self.replicas)

    def flush(self, timeout: float = 30.0) -> None:
        """Wait until each replica's batch path holds no batch and no
        bind is in flight."""
        for sched, bs in zip(self.replicas, self.batch_schedulers
                             or [None] * len(self.replicas)):
            if bs is not None:
                bs.flush(timeout=timeout)
            sched.wait_for_inflight_bindings(timeout=timeout)

    def stale_binds_rejected(self) -> Dict[str, int]:
        """Refused commits summed over the replicas, by path."""
        out: Dict[str, int] = {}
        for sched in self.replicas:
            for path, n in sched.stale_binds_rejected.items():
                out[path] = out.get(path, 0) + n
        return out

    def stop(self) -> None:
        for sched in self.replicas:
            sched.stop()
