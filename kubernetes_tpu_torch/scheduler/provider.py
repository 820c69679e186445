"""The providers' plugin wiring: per extension point, the plugins in
order, and each score plugin's weight. ``PROVIDERS`` maps a provider's
name to its wiring. The default wiring scores with MeshLocality at
weight 1 (0 on every node for a pod without a mesh block); the cluster
autoscaler's packs pods (MostAllocated in LeastAllocated's place)."""

from typing import Dict, List, Tuple

Wiring = Dict[str, List[Tuple[str, int]]]


def default_plugins() -> Wiring:
    return {
        "queue_sort": [("PrioritySort", 1)],
        "pre_filter": [("NodeResourcesFit", 1), ("NodePorts", 1),
                       ("PodTopologySpread", 1), ("InterPodAffinity", 1),
                       ("VolumeBinding", 1)],
        "filter": [("NodeUnschedulable", 1), ("NodeName", 1),
                   ("TaintToleration", 1), ("NodeAffinity", 1),
                   ("NodePorts", 1), ("NodeResourcesFit", 1),
                   ("VolumeRestrictions", 1), ("EBSLimits", 1),
                   ("GCEPDLimits", 1), ("NodeVolumeLimits", 1),
                   ("AzureDiskLimits", 1), ("VolumeBinding", 1),
                   ("VolumeZone", 1), ("PodTopologySpread", 1),
                   ("InterPodAffinity", 1)],
        "post_filter": [("DefaultPreemption", 1)],
        "pre_score": [("InterPodAffinity", 1), ("PodTopologySpread", 1),
                      ("TaintToleration", 1), ("SelectorSpread", 1)],
        "score": [("NodeResourcesBalancedAllocation", 1),
                  ("ImageLocality", 1), ("InterPodAffinity", 1),
                  ("NodeResourcesLeastAllocated", 1), ("NodeAffinity", 1),
                  ("NodePreferAvoidPods", 10000), ("PodTopologySpread", 2),
                  ("TaintToleration", 1), ("MeshLocality", 1),
                  ("SelectorSpread", 1)],
        "reserve": [("VolumeBinding", 1)],
        "pre_bind": [("VolumeBinding", 1)],
        "bind": [("DefaultBinder", 1)],
    }


def gang_scheduling_plugins() -> Wiring:
    """The default wiring plus coscheduling: the gang-aware queue sort
    (PrioritySort's order for pods of no gang), the gang backoff at
    PreFilter and the Permit gate."""
    p = default_plugins()
    p["queue_sort"] = [("CoschedulingSort", 1)]
    p["pre_filter"] = p["pre_filter"] + [("Coscheduling", 1)]
    p["permit"] = [("Coscheduling", 1)]
    return p


def cluster_autoscaler_plugins() -> Wiring:
    """The default wiring with NodeResourcesMostAllocated scoring in
    NodeResourcesLeastAllocated's place, at its weight."""
    p = default_plugins()
    p["score"] = [("NodeResourcesMostAllocated", w)
                  if name == "NodeResourcesLeastAllocated" else (name, w)
                  for name, w in p["score"]]
    return p


PROVIDERS = {
    "DefaultProvider": default_plugins,
    "ClusterAutoscalerProvider": cluster_autoscaler_plugins,
    "GangSchedulingProvider": gang_scheduling_plugins,
}
