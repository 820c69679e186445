"""The in-tree plugins of the default provider (MeshLocality included),
the coscheduling plugins, and their registry (plugin name -> factory)."""

from typing import Callable, Dict


def new_in_tree_registry() -> Dict[str, Callable]:
    from kubernetes_tpu_torch.scheduler.framework.plugins import (
        coscheduling,
        default_binder,
        default_preemption,
        image_locality,
        interpod_affinity,
        mesh_locality,
        node_affinity,
        node_name,
        node_volume_limits,
        node_ports,
        node_prefer_avoid_pods,
        node_resources,
        node_unschedulable,
        pod_topology_spread,
        queue_sort,
        selector_spread,
        taint_toleration,
        volume_binding,
        volume_restrictions,
        volume_zone,
    )

    return {cls.NAME: cls.factory for cls in (
        queue_sort.PrioritySort,
        node_resources.Fit,
        node_resources.BalancedAllocation,
        node_resources.LeastAllocated,
        node_resources.MostAllocated,
        node_name.NodeName,
        node_ports.NodePorts,
        node_unschedulable.NodeUnschedulable,
        node_affinity.NodeAffinity,
        node_prefer_avoid_pods.NodePreferAvoidPods,
        taint_toleration.TaintToleration,
        interpod_affinity.InterPodAffinity,
        pod_topology_spread.PodTopologySpread,
        selector_spread.SelectorSpread,
        image_locality.ImageLocality,
        mesh_locality.MeshLocality,
        volume_binding.VolumeBinding,
        volume_restrictions.VolumeRestrictions,
        volume_zone.VolumeZone,
        node_volume_limits.CSILimits,
        node_volume_limits.EBSLimits,
        node_volume_limits.GCEPDLimits,
        node_volume_limits.AzureDiskLimits,
        default_preemption.DefaultPreemption,
        default_binder.DefaultBinder,
        coscheduling.Coscheduling,
        coscheduling.CoschedulingSort,
    )}
