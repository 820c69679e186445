"""The federation tier: K independent clusters behind a cross-cluster
client, a what-if federation scheduler (clusters as solve columns) and a
cluster-granularity rebalancer. The federation is an optimizer, never a
single point of failure: with the layer down every cell keeps
scheduling its own pods."""

from kubernetes_tpu_torch.federation.client import (
    FederatedClusterClient,
    HomeMap,
)
from kubernetes_tpu_torch.federation.ledger import (
    CapacityLedger,
    ClusterCapacity,
)
from kubernetes_tpu_torch.federation.rebalancer import ClusterRebalancer
from kubernetes_tpu_torch.federation.scheduler import (
    GANG_NAME_LABEL,
    REMOTE_CLUSTER_PENALTY,
    SATURATION_PENALTY,
    FederationPolicy,
    FederationScheduler,
    FederationUnavailable,
    Placement,
    PlacementUnit,
    group_units,
)

__all__ = [
    "CapacityLedger",
    "ClusterCapacity",
    "ClusterRebalancer",
    "FederatedClusterClient",
    "FederationPolicy",
    "FederationScheduler",
    "FederationUnavailable",
    "GANG_NAME_LABEL",
    "HomeMap",
    "Placement",
    "PlacementUnit",
    "REMOTE_CLUSTER_PENALTY",
    "SATURATION_PENALTY",
    "group_units",
]
