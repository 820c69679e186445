"""The scheduler's component configuration (upstream
``pkg/scheduler/apis/config/types.go`` KubeSchedulerConfiguration):
parallelism, the percentage of nodes to score, the backoff bounds, per
profile the enabled and disabled plugin sets with their weights and each
plugin's args, and the extenders. ``from_dict`` reads v1beta1-shaped
dicts; ``validate`` lists every error, in the order they are found."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional

DEFAULT_PERCENTAGE_OF_NODES_TO_SCORE = 0  # 0 = adaptive
MIN_FEASIBLE_NODES_TO_FIND = 100          # generic_scheduler.go:47-52
MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND = 5
DEFAULT_PARALLELISM = 16

EXTENSION_POINTS = (
    "queue_sort",
    "pre_filter",
    "filter",
    "post_filter",
    "pre_score",
    "score",
    "reserve",
    "permit",
    "pre_bind",
    "bind",
    "post_bind",
)

_CAMEL = {
    "queue_sort": "queueSort",
    "pre_filter": "preFilter",
    "filter": "filter",
    "post_filter": "postFilter",
    "pre_score": "preScore",
    "score": "score",
    "reserve": "reserve",
    "permit": "permit",
    "pre_bind": "preBind",
    "bind": "bind",
    "post_bind": "postBind",
}


@dataclass
class PluginEntry:
    name: str
    weight: int = 1


@dataclass
class PluginSet:
    enabled: List[PluginEntry] = field(default_factory=list)
    disabled: List[PluginEntry] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Optional[Mapping]) -> "PluginSet":
        d = d or {}
        return cls(
            enabled=[
                PluginEntry(e["name"], int(e.get("weight") or 1))
                for e in (d.get("enabled") or [])
            ],
            disabled=[
                PluginEntry(e["name"]) for e in (d.get("disabled") or [])
            ],
        )


@dataclass
class Plugins:
    queue_sort: PluginSet = field(default_factory=PluginSet)
    pre_filter: PluginSet = field(default_factory=PluginSet)
    filter: PluginSet = field(default_factory=PluginSet)
    post_filter: PluginSet = field(default_factory=PluginSet)
    pre_score: PluginSet = field(default_factory=PluginSet)
    score: PluginSet = field(default_factory=PluginSet)
    reserve: PluginSet = field(default_factory=PluginSet)
    permit: PluginSet = field(default_factory=PluginSet)
    pre_bind: PluginSet = field(default_factory=PluginSet)
    bind: PluginSet = field(default_factory=PluginSet)
    post_bind: PluginSet = field(default_factory=PluginSet)

    def get(self, point: str) -> PluginSet:
        return getattr(self, point)

    def merge_defaults(self, defaults: "Plugins") -> "Plugins":
        """Profile plugins overlay the provider defaults: enabled appends,
        disabled removes ("*" disables all defaults) — upstream
        apis/config/v1beta1 mergePlugins semantics."""
        out = Plugins()
        for point in EXTENSION_POINTS:
            dset, pset = defaults.get(point), self.get(point)
            disabled = {e.name for e in pset.disabled}
            enabled = []
            if "*" not in disabled:
                enabled = [e for e in dset.enabled if e.name not in disabled]
            enabled += [e for e in pset.enabled]
            out.get(point).enabled = enabled
        return out

    @classmethod
    def from_dict(cls, d: Optional[Mapping]) -> "Plugins":
        d = d or {}
        p = cls()
        for point in EXTENSION_POINTS:
            setattr(p, point, PluginSet.from_dict(d.get(_CAMEL[point])))
        return p


@dataclass
class PluginConfig:
    name: str
    args: Dict[str, Any] = field(default_factory=dict)


@dataclass
class KubeSchedulerProfile:
    scheduler_name: str = "default-scheduler"
    plugins: Optional[Plugins] = None
    plugin_config: List[PluginConfig] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Mapping) -> "KubeSchedulerProfile":
        return cls(
            scheduler_name=d.get("schedulerName", "default-scheduler"),
            plugins=Plugins.from_dict(d["plugins"]) if "plugins" in d else None,
            plugin_config=[
                PluginConfig(c["name"], dict(c.get("args") or {}))
                for c in (d.get("pluginConfig") or [])
            ],
        )

    def get_plugin_args(self, name: str) -> Dict[str, Any]:
        for c in self.plugin_config:
            if c.name == name:
                return c.args
        return {}


@dataclass
class Extender:
    """One HTTP extender. ``implementation``: an object whose ``filter``,
    ``prioritize``, ``bind`` and ``process_preemption`` methods take the
    verbs' JSON payloads in process, in place of HTTP."""

    url_prefix: str = ""
    filter_verb: str = ""
    preempt_verb: str = ""
    prioritize_verb: str = ""
    bind_verb: str = ""
    weight: int = 1
    enable_https: bool = False
    http_timeout: float = 30.0
    node_cache_capable: bool = False
    managed_resources: List[str] = field(default_factory=list)
    ignorable: bool = False
    # test/in-process hook: a python object implementing the verbs directly
    implementation: Any = None

    def is_interested(self, pod) -> bool:
        if not self.managed_resources:
            return True
        names = set()
        for c in pod.spec.containers + pod.spec.init_containers:
            names.update(c.resources.requests)
            names.update(c.resources.limits)
        return bool(names & set(self.managed_resources))


@dataclass
class KubeSchedulerConfiguration:
    parallelism: int = DEFAULT_PARALLELISM
    percentage_of_nodes_to_score: int = DEFAULT_PERCENTAGE_OF_NODES_TO_SCORE
    pod_initial_backoff_seconds: float = 1.0
    pod_max_backoff_seconds: float = 10.0
    profiles: List[KubeSchedulerProfile] = field(
        default_factory=lambda: [KubeSchedulerProfile()]
    )
    extenders: List[Extender] = field(default_factory=list)
    feature_gates: Dict[str, bool] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Mapping) -> "KubeSchedulerConfiguration":
        cfg = cls(
            parallelism=int(d.get("parallelism", DEFAULT_PARALLELISM)),
            percentage_of_nodes_to_score=int(d.get("percentageOfNodesToScore", 0)),
            pod_initial_backoff_seconds=float(d.get("podInitialBackoffSeconds", 1)),
            pod_max_backoff_seconds=float(d.get("podMaxBackoffSeconds", 10)),
            feature_gates=dict(d.get("featureGates") or {}),
        )
        if d.get("profiles"):
            cfg.profiles = [KubeSchedulerProfile.from_dict(p) for p in d["profiles"]]
        if d.get("extenders"):
            cfg.extenders = [
                Extender(
                    url_prefix=e.get("urlPrefix", ""),
                    filter_verb=e.get("filterVerb", ""),
                    preempt_verb=e.get("preemptVerb", ""),
                    prioritize_verb=e.get("prioritizeVerb", ""),
                    bind_verb=e.get("bindVerb", ""),
                    weight=int(e.get("weight", 1)),
                    http_timeout=float(e.get("httpTimeout", 30)),
                    node_cache_capable=bool(e.get("nodeCacheCapable")),
                    managed_resources=[
                        m["name"] for m in (e.get("managedResources") or [])
                    ],
                    ignorable=bool(e.get("ignorable")),
                )
                for e in d["extenders"]
            ]
        return cfg

    def validate(self) -> List[str]:
        """The v1beta1 validation's errors, as messages."""
        errs = []
        if self.parallelism <= 0:
            errs.append("parallelism must be positive")
        if not (0 <= self.percentage_of_nodes_to_score <= 100):
            errs.append("percentageOfNodesToScore must be in [0,100]")
        if self.pod_initial_backoff_seconds <= 0:
            errs.append("podInitialBackoffSeconds must be positive")
        if self.pod_max_backoff_seconds < self.pod_initial_backoff_seconds:
            errs.append("podMaxBackoffSeconds must be >= podInitialBackoffSeconds")
        names = [p.scheduler_name for p in self.profiles]
        if len(set(names)) != len(names):
            errs.append("profile schedulerNames must be unique")
        for p in self.profiles:
            if not p.scheduler_name:
                errs.append("schedulerName cannot be empty")
            if p.plugins is not None:
                for point in EXTENSION_POINTS:
                    for e in p.plugins.get(point).enabled:
                        if not e.name:
                            errs.append(
                                f"{p.scheduler_name}: {point} plugin "
                                "name cannot be empty")
                        if point == "score" and not 0 <= e.weight <= 100:
                            # framework MaxTotalScoreWeight discipline
                            # (apis/config/validation)
                            errs.append(
                                f"{p.scheduler_name}: score plugin "
                                f"{e.name!r} weight {e.weight} not in "
                                "[0,100]")
        binders = 0
        for ext in self.extenders:
            if not ext.url_prefix and ext.implementation is None:
                errs.append("extender urlPrefix cannot be empty")
            if ext.weight <= 0:
                errs.append("extender weight must be positive")
            if ext.bind_verb:
                binders += 1
        if binders > 1:
            # v1beta1 validation: only one extender may be the binder
            errs.append("only one extender can implement bind")
        return errs
