"""Feature gates: the scheduler-relevant subset of the upstream gates,
and this package's own. ``TPUBatchScheduler`` installs the batch path
(``sidecar.attach_batch_scheduler``); ``DefaultPodTopologySpread`` drops
SelectorSpread from the providers' wiring; ``PreferNominatedNode`` lets
the serial path try a pod's nominated node first."""

from __future__ import annotations

from typing import Dict, Mapping

_DEFAULTS: Dict[str, bool] = {
    # upstream gates the scheduler reads
    "PreferNominatedNode": False,
    "DefaultPodTopologySpread": False,
    "PodOverhead": True,
    "BalanceAttachedNodeVolumes": False,
    "VolumeCapacityPriority": False,
    "NonPreemptingPriority": True,
    # this package's gates
    "TPUBatchScheduler": False,
    "TPUShardedSolver": False,
}


class FeatureGates:
    def __init__(self, overrides: Mapping[str, bool] = ()):
        self._gates = dict(_DEFAULTS)
        self._gates.update(dict(overrides or {}))

    def enabled(self, name: str) -> bool:
        return self._gates.get(name, False)

    def set(self, name: str, value: bool) -> None:
        self._gates[name] = value

    @classmethod
    def from_string(cls, s: str) -> "FeatureGates":
        """Parse the ``--feature-gates=A=true,B=false`` syntax (a bare
        name enables its gate)."""
        overrides = {}
        for part in (s or "").split(","):
            part = part.strip()
            if not part:
                continue
            k, _, v = part.partition("=")
            overrides[k.strip()] = v.strip().lower() in ("true", "1", "")
        return cls(overrides)


def default_feature_gates() -> FeatureGates:
    return FeatureGates()
