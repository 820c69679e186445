"""ClusterRebalancer: ``plan_rebalance`` a level up, clusters in the
partitions' place.

- a dead cluster -> **failover** (its pods created again on the
  survivors), before anything else;
- one tenant dominating the fleet's writes -> **split** (release the
  namespace from its home cluster, so placement spreads it);
- one hot cluster, siblings cold -> **move** (re-home the hot cluster's
  hottest namespace onto the coldest sibling);
- buy and retire -> recorded, nothing done (the clusters are fixed;
  each cluster's node autoscaler owns its elasticity).

``ClusterRebalancer`` is ``PartitionRebalancer`` (the same tick,
differencing, sustain and cooldown, the same planner) with a driver that
adapts the ``CapacityLedger``'s write counters, the ``HomeMap`` and
``FederatedClusterClient.failover_cluster`` to the driver's contract.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from kubernetes_tpu_torch.autoscaler.partitions import (
    PartitionGroup,
    PartitionRebalancer,
    RebalancePolicy,
)
from kubernetes_tpu_torch.federation.client import FederatedClusterClient


class _ClusterTopologyView:
    """The planner's topology with clusters as slots: cluster i is the
    one slot of partition i. ``spread``: the namespaces already
    released."""

    def __init__(self, clusters: List[int], dead: List[int], spread: set):
        self.partitions = (max(clusters) + 1) if clusters else 0
        self.retired = {p for p in range(self.partitions)
                        if p not in clusters}
        self.owner = list(range(self.partitions))
        self.spread = set(spread)
        self._dead = set(dead)

    def slots_of_partition(self, p: int) -> List[int]:
        if p in self.retired or p in self._dead:
            return []
        return [p]


class _FederationDriver:
    """The federation tier behind the rebalancer's driver contract."""

    def __init__(self, client: FederatedClusterClient):
        self.client = client
        self.ledger = client.ledger
        self.home_map = client.home_map
        # a dead cluster stays dead: reported once, or the planner would
        # fire failover every tick
        self._failed_over: set = set()

    def observe(self) -> dict:
        cluster_writes, ns_writes = self.ledger.write_counts()
        all_dead = self.ledger.dead_clusters()
        # every dead cluster stays slotless (never a target of a move);
        # only the failover trigger sees each death once
        topo = _ClusterTopologyView(self.ledger.clusters(), all_dead,
                                    self.home_map.spread)
        return {"epoch": 0, "topology": topo,
                "slot_writes": dict(cluster_writes),
                "ns_writes": dict(ns_writes),
                "dead": [c for c in all_dead if c not in self._failed_over]}

    def federate(self) -> None:
        """Nothing to gather: the ledger is already the fleet's view."""

    def apply(self, action: Dict[str, Any]) -> dict:
        op = action["op"]
        if op == "failover":
            cid = action["partition"]
            self._failed_over.add(cid)
            return {"cluster": cid,
                    "replaced": self.client.failover_cluster(cid)}
        if op == "split":
            ns = action["namespace"]
            self.home_map.spread.add(ns)
            return {"namespace": ns, "spread": True}
        if op == "move":
            # {hot cluster: coldest}: re-home the hot cluster's hottest
            # namespace
            moved: Dict[str, int] = {}
            for src, dst in action["assignments"].items():
                ns = self._hottest_ns_homed_on(src)
                if ns is not None:
                    self.home_map.overrides[ns] = dst
                    moved[ns] = dst
            return {"moved": moved}
        return {"noop": op}

    def _hottest_ns_homed_on(self, cid: int) -> Optional[str]:
        _, ns_writes = self.ledger.write_counts()
        best, best_rate = None, 0.0
        for ns, rate in ns_writes.items():
            if self.home_map.home_of(ns) == cid and rate > best_rate:
                best, best_rate = ns, rate
        return best


class ClusterRebalancer(PartitionRebalancer):
    """The partition rebalancer's loop pointed at clusters."""

    def __init__(self, client: FederatedClusterClient,
                 group: Optional[PartitionGroup] = None,
                 policy: Optional[RebalancePolicy] = None,
                 interval_s: float = 0.5):
        super().__init__(
            _FederationDriver(client),
            group=group or PartitionGroup(name="federation",
                                          max_partitions=64),
            policy=policy, interval_s=interval_s)
