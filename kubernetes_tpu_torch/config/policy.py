"""The legacy Policy API translated into plugin configuration (upstream
``pkg/scheduler/factory.go`` createFromConfig and
``framework/plugins/legacy_registry.go``): a v1 Policy document lists
predicate and priority names, and each maps to a plugin at its extension
points. QueueSort, Bind and PostFilter (preemption) are always wired,
whatever the Policy says. A Policy is the only way to the NodeLabel and
ServiceAffinity plugins.

Usage::

    cfg = policy_to_config(json.loads(policy_text))
    sched = Scheduler.create(store, config=cfg)
"""

from __future__ import annotations

import json
from typing import Any, List, Mapping, Optional

from kubernetes_tpu_torch.config.types import (
    EXTENSION_POINTS,
    KubeSchedulerConfiguration,
    KubeSchedulerProfile,
    PluginConfig,
    PluginEntry,
    Plugins,
)

# legacy predicate name -> (plugin, extension points)
# (legacy_registry.go registeredPredicates)
PREDICATE_MAP = {
    "PodFitsResources": ("NodeResourcesFit", ("pre_filter", "filter")),
    "PodFitsHostPorts": ("NodePorts", ("pre_filter", "filter")),
    "HostName": ("NodeName", ("filter",)),
    "MatchNodeSelector": ("NodeAffinity", ("filter",)),
    "NoDiskConflict": ("VolumeRestrictions", ("filter",)),
    "NoVolumeZoneConflict": ("VolumeZone", ("filter",)),
    "PodToleratesNodeTaints": ("TaintToleration", ("filter",)),
    "CheckNodeUnschedulable": ("NodeUnschedulable", ("filter",)),
    "MaxCSIVolumeCountPred": ("NodeVolumeLimits", ("filter",)),
    "MaxEBSVolumeCount": ("EBSLimits", ("filter",)),
    "MaxGCEPDVolumeCount": ("GCEPDLimits", ("filter",)),
    "MaxAzureDiskVolumeCount": ("AzureDiskLimits", ("filter",)),
    "MatchInterPodAffinity": (
        "InterPodAffinity", ("pre_filter", "filter"),
    ),
    "EvenPodsSpread": ("PodTopologySpread", ("pre_filter", "filter")),
    "CheckVolumeBinding": (
        "VolumeBinding", ("pre_filter", "filter", "reserve", "pre_bind"),
    ),
    "TestServiceAffinity": ("ServiceAffinity", ("pre_filter", "filter")),
    "CheckNodeLabelPresence": ("NodeLabel", ("filter",)),
}

# legacy priority name -> (plugin, extension points)
# (legacy_registry.go registeredPriorities)
PRIORITY_MAP = {
    "LeastRequestedPriority": (
        "NodeResourcesLeastAllocated", ("score",),
    ),
    "MostRequestedPriority": ("NodeResourcesMostAllocated", ("score",)),
    "BalancedResourceAllocation": (
        "NodeResourcesBalancedAllocation", ("score",),
    ),
    "SelectorSpreadPriority": ("SelectorSpread", ("pre_score", "score")),
    "ServiceSpreadingPriority": ("SelectorSpread", ("pre_score", "score")),
    "InterPodAffinityPriority": ("InterPodAffinity", ("pre_score", "score")),
    "NodeAffinityPriority": ("NodeAffinity", ("score",)),
    "TaintTolerationPriority": ("TaintToleration", ("pre_score", "score")),
    "ImageLocalityPriority": ("ImageLocality", ("score",)),
    "NodePreferAvoidPodsPriority": ("NodePreferAvoidPods", ("score",)),
    "RequestedToCapacityRatioPriority": (
        "RequestedToCapacityRatio", ("score",),
    ),
    "EvenPodsSpreadPriority": ("PodTopologySpread", ("pre_score", "score")),
}


class PolicyError(ValueError):
    pass


def policy_to_config(
    policy: Mapping[str, Any],
    feature_gates: Optional[Mapping[str, bool]] = None,
) -> KubeSchedulerConfiguration:
    """Translate a v1 Policy document (dict) into a
    KubeSchedulerConfiguration with one default profile."""
    if policy.get("kind") not in (None, "Policy"):
        raise PolicyError(f"not a Policy document: kind={policy.get('kind')!r}")
    plugins = Plugins()

    def enable(point: str, name: str, weight: int = 1) -> None:
        """Idempotent for non-score points; score weights ACCUMULATE when
        two legacy priorities map to one plugin (legacy_registry.go: e.g.
        SelectorSpreadPriority + ServiceSpreadingPriority both feed
        SelectorSpread, and createFromConfig sums their weights)."""
        pset = plugins.get(point)
        for e in pset.enabled:
            if e.name == name:
                if point == "score":
                    e.weight += weight
                return
        pset.enabled.append(PluginEntry(name, weight))

    # mandatory wiring createFromConfig always applies (factory.go:253-272)
    enable("queue_sort", "PrioritySort")
    enable("bind", "DefaultBinder")
    enable("post_filter", "DefaultPreemption")

    predicates = policy.get("predicates")
    if predicates is None:
        # nil predicate list -> provider defaults for the filter side
        # (factory.go:215-222 applies the default provider's set)
        for name, (plugin, points) in PREDICATE_MAP.items():
            if name in _DEFAULT_PREDICATES:
                for point in points:
                    enable(point, plugin)
    else:
        for entry in predicates:
            name = entry.get("name")
            if name not in PREDICATE_MAP:
                raise PolicyError(f"unknown predicate {name!r}")
            plugin, points = PREDICATE_MAP[name]
            for point in points:
                enable(point, plugin)

    priorities = policy.get("priorities")
    if priorities is None:
        for name, (plugin, points) in PRIORITY_MAP.items():
            if name in _DEFAULT_PRIORITIES:
                for point in points:
                    enable(point, plugin)
    else:
        for entry in priorities:
            name = entry.get("name")
            weight = int(entry["weight"]) if entry.get("weight") is not None \
                else 1
            if weight <= 0 or weight >= 2**63 - 1:
                # upstream createFromConfig: "priority ... should have
                # a positive weight applied to it or it has overflown"
                # (Weight <= 0 || Weight >= framework.MaxTotalScore) —
                # do not silently coerce an explicit 0 to 1
                raise PolicyError(
                    f"priority {name!r} weight must be positive and "
                    f"must not overflow"
                )
            if name not in PRIORITY_MAP:
                raise PolicyError(f"unknown priority {name!r}")
            plugin, points = PRIORITY_MAP[name]
            for point in points:
                enable(point, plugin, weight if point == "score" else 1)

    plugin_config: List[PluginConfig] = []
    hard_weight = policy.get("hardPodAffinitySymmetricWeight")
    if hard_weight is not None:
        if not 0 <= int(hard_weight) <= 100:
            raise PolicyError(
                "hardPodAffinitySymmetricWeight must be in [0,100]")
        plugin_config.append(PluginConfig(
            "InterPodAffinity",
            {"hardPodAffinityWeight": int(hard_weight)},
        ))

    # a Policy REPLACES the provider defaults (createFromConfig builds
    # the plugin set from scratch): disable "*" so merge_defaults keeps
    # only the translated set
    for point in EXTENSION_POINTS:
        plugins.get(point).disabled.append(PluginEntry("*"))

    profile = KubeSchedulerProfile(
        scheduler_name="default-scheduler",
        plugins=plugins,
        plugin_config=plugin_config,
    )
    cfg = KubeSchedulerConfiguration(
        profiles=[profile],
        feature_gates=dict(feature_gates or {}),
    )
    if policy.get("extenders"):
        cfg.extenders = KubeSchedulerConfiguration.from_dict(
            {"extenders": policy["extenders"]}
        ).extenders
    return cfg


def load_policy(text: str, **kw) -> KubeSchedulerConfiguration:
    """Parse Policy JSON text (the --policy-config-file path,
    scheduler.go:241-262)."""
    try:
        doc = json.loads(text)
    except json.JSONDecodeError as e:
        raise PolicyError(f"invalid Policy JSON: {e}") from e
    return policy_to_config(doc, **kw)


# the default provider's legacy-name sets (algorithmprovider
# defaults expressed in Policy vocabulary)
_DEFAULT_PREDICATES = {
    "PodFitsResources", "PodFitsHostPorts", "HostName",
    "MatchNodeSelector", "NoVolumeZoneConflict", "PodToleratesNodeTaints",
    "CheckNodeUnschedulable", "MaxCSIVolumeCountPred",
    "MatchInterPodAffinity", "EvenPodsSpread", "CheckVolumeBinding",
    "NoDiskConflict",
}
_DEFAULT_PRIORITIES = {
    "LeastRequestedPriority", "BalancedResourceAllocation",
    "SelectorSpreadPriority", "InterPodAffinityPriority",
    "NodeAffinityPriority", "TaintTolerationPriority",
    "ImageLocalityPriority", "NodePreferAvoidPodsPriority",
    "EvenPodsSpreadPriority",
}
