"""The scheduler's component configuration: feature gates, the v1beta1
``KubeSchedulerConfiguration`` (profiles, plugin sets, plugin args,
extenders) and the legacy ``Policy`` translation."""

from kubernetes_tpu_torch.config.feature_gates import (  # noqa: F401
    FeatureGates,
    default_feature_gates,
)
from kubernetes_tpu_torch.config.types import (  # noqa: F401
    Extender,
    KubeSchedulerConfiguration,
    KubeSchedulerProfile,
    PluginConfig,
    PluginEntry,
    Plugins,
    PluginSet,
)
