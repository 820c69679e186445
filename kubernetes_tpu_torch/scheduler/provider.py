"""The providers' plugin wiring: per extension point, the plugins in
order, and each score plugin's weight (a ``config.types.Plugins``).
``PROVIDERS`` maps a provider's name to ``fn(feature_gates=None)``. The
default wiring scores with MeshLocality at weight 1 (0 on every node for
a pod without a mesh block), and with SelectorSpread unless the
``DefaultPodTopologySpread`` gate is on; the cluster autoscaler's packs
pods (MostAllocated in LeastAllocated's place); the gang scheduling
provider adds coscheduling."""

from kubernetes_tpu_torch.config.types import PluginEntry, Plugins, PluginSet


def _set(*entries) -> PluginSet:
    return PluginSet(enabled=[PluginEntry(*e) if isinstance(e, tuple)
                              else PluginEntry(e) for e in entries])


def default_plugins(feature_gates=None) -> Plugins:
    p = Plugins()
    p.queue_sort = _set("PrioritySort")
    p.pre_filter = _set("NodeResourcesFit", "NodePorts", "PodTopologySpread",
                        "InterPodAffinity", "VolumeBinding")
    p.filter = _set("NodeUnschedulable", "NodeName", "TaintToleration",
                    "NodeAffinity", "NodePorts", "NodeResourcesFit",
                    "VolumeRestrictions", "EBSLimits", "GCEPDLimits",
                    "NodeVolumeLimits", "AzureDiskLimits", "VolumeBinding",
                    "VolumeZone", "PodTopologySpread", "InterPodAffinity")
    p.post_filter = _set("DefaultPreemption")
    p.pre_score = _set("InterPodAffinity", "PodTopologySpread",
                       "TaintToleration")
    p.score = _set(("NodeResourcesBalancedAllocation", 1),
                   ("ImageLocality", 1), ("InterPodAffinity", 1),
                   ("NodeResourcesLeastAllocated", 1), ("NodeAffinity", 1),
                   ("NodePreferAvoidPods", 10000), ("PodTopologySpread", 2),
                   ("TaintToleration", 1), ("MeshLocality", 1))
    p.reserve = _set("VolumeBinding")
    p.pre_bind = _set("VolumeBinding")
    p.bind = _set("DefaultBinder")
    # the legacy default spreading, unless DefaultPodTopologySpread moved
    # it into PodTopologySpread's defaults
    if feature_gates is None or not feature_gates.enabled(
            "DefaultPodTopologySpread"):
        p.pre_score.enabled.append(PluginEntry("SelectorSpread"))
        p.score.enabled.append(PluginEntry("SelectorSpread", 1))
    return p


def gang_scheduling_plugins(feature_gates=None) -> Plugins:
    """The default wiring plus coscheduling: the gang-aware queue sort
    (PrioritySort's order for pods of no gang), the gang backoff at
    PreFilter and the Permit gate."""
    p = default_plugins(feature_gates)
    p.queue_sort = _set("CoschedulingSort")
    p.pre_filter.enabled.append(PluginEntry("Coscheduling"))
    p.permit = _set("Coscheduling")
    return p


def cluster_autoscaler_plugins(feature_gates=None) -> Plugins:
    """The default wiring with NodeResourcesMostAllocated scoring in
    NodeResourcesLeastAllocated's place, at its weight."""
    p = default_plugins(feature_gates)
    p.score.enabled = [PluginEntry("NodeResourcesMostAllocated", e.weight)
                       if e.name == "NodeResourcesLeastAllocated" else e
                       for e in p.score.enabled]
    return p


PROVIDERS = {
    "DefaultProvider": default_plugins,
    "ClusterAutoscalerProvider": cluster_autoscaler_plugins,
    "GangSchedulingProvider": gang_scheduling_plugins,
}
