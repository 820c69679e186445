"""Wire-level fault injection for the REST fabric (the chaos-over-REST
half of the chaos ring; reference ``test/e2e/chaosmonkey`` + the
apiserver's own failure modes clients must survive: connection resets,
truncated responses, added latency, 429/503 overload pushback, stalled
and dropped watch streams).

A ``FaultGate`` sits in front of the handler chain in ``rest.py``. Rules
match per-verb and per-resource, fire with a configured probability from
a SEEDED RNG (a chaos run replays exactly), and optionally carry a
finite ``count`` (bursts). The gate is togglable at runtime through the
``/debug/faults`` admin endpoint, which is itself never faulted — chaos
must not be able to lock you out of the chaos controls.

Fault vocabulary:

- ``reset``        — abort the TCP connection (SO_LINGER 0 → RST), no
                     response bytes at all;
- ``truncate``     — serve the real response but cut the byte stream
                     after ``truncate_bytes``, then abort;
- ``latency``      — sleep ``latency`` seconds, then serve normally;
- ``error``        — answer ``code`` (429/503) with ``Retry-After``;
- ``watch_stall``  — pause a watch stream ``duration`` seconds before
                     the next frame;
- ``watch_drop``   — abort a watch stream mid-flight (no terminating
                     chunk), forcing the client's relist path.

Every injection increments ``faults_injected_total{fault,resource}``.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, List, Optional

FAULTS = ("reset", "truncate", "latency", "error",
          "watch_stall", "watch_drop")
_WATCH_FAULTS = ("watch_stall", "watch_drop")


def api_segments(path: str) -> List[str]:
    """Resource-route segments of an API path with the ``/api/v1`` or
    ``/apis/<group>/<version>`` prefix and any ``namespaces/<ns>`` pair
    stripped (kept when the namespace itself IS the object, as in
    ``/api/v1/namespaces/default``). The ONE route parser behind fault
    matching and flowcontrol's width estimation — a future route-shape
    change lands here, not in per-module copies."""
    parts = [p for p in path.split("?", 1)[0].split("/") if p]
    if not parts:
        return []
    if parts[0] == "api":
        rest = parts[2:]        # /api/v1/...
    elif parts[0] == "apis":
        rest = parts[3:]        # /apis/<g>/<v>/...
    else:
        return []
    if rest and rest[0] == "namespaces" and len(rest) >= 3:
        rest = rest[2:]
    return rest


def resource_of(path: str) -> str:
    """Plural resource segment of an API path ("pods", "nodes", ...);
    "" for non-resource paths. Mirrors the route logic in rest.py
    without needing the resolved kind."""
    rest = api_segments(path)
    return rest[0] if rest else ""


def namespace_of(path: str) -> str:
    """Namespace segment of an API path; "" when cluster-scoped."""
    parts = [p for p in path.split("?", 1)[0].split("/") if p]
    for i, part in enumerate(parts):
        if part == "namespaces" and i + 1 < len(parts):
            return parts[i + 1]
    return ""


class FaultRule:
    """One matching rule. ``count=None`` means unlimited; a finite count
    is decremented per injection (the "burst" shape: N consecutive 429s,
    one reset, ...)."""

    def __init__(self, fault: str, verb: str = "*", resource: str = "*",
                 probability: float = 1.0, count: Optional[int] = None,
                 latency: float = 0.05, code: int = 503,
                 retry_after: float = 1.0, truncate_bytes: int = 120,
                 duration: float = 0.5):
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r} (one of {FAULTS})")
        if not 0.0 <= probability <= 1.0:
            raise ValueError(f"probability out of range: {probability}")
        if fault == "error" and code not in (429, 500, 503):
            raise ValueError(f"error fault code must be 429/500/503, "
                             f"got {code}")
        self.fault = fault
        self.verb = verb.upper()
        self.resource = resource
        self.probability = float(probability)
        self.count = None if count is None else int(count)
        self.latency = float(latency)
        self.code = int(code)
        self.retry_after = float(retry_after)
        self.truncate_bytes = int(truncate_bytes)
        self.duration = float(duration)

    def matches(self, verb: str, resource: str, watch: bool) -> bool:
        if watch != (self.fault in _WATCH_FAULTS):
            return False
        if self.verb != "*" and self.verb != verb.upper():
            return False
        if self.resource != "*" and self.resource != resource:
            return False
        return True

    @classmethod
    def from_dict(cls, spec: Dict) -> "FaultRule":
        known = {"fault", "verb", "resource", "probability", "count",
                 "latency", "code", "retry_after", "truncate_bytes",
                 "duration"}
        unknown = set(spec) - known
        if unknown:
            raise ValueError(f"unknown rule fields: {sorted(unknown)}")
        return cls(**spec)

    def to_dict(self) -> Dict:
        return {
            "fault": self.fault, "verb": self.verb,
            "resource": self.resource, "probability": self.probability,
            "count": self.count, "latency": self.latency,
            "code": self.code, "retry_after": self.retry_after,
            "truncate_bytes": self.truncate_bytes,
            "duration": self.duration,
        }


class FaultGate:
    """Seeded, runtime-reconfigurable fault decider. With no rules the
    per-request cost is one attribute read — the gate always exists, so
    steady-state benchmarks pay nothing measurable."""

    def __init__(self, seed: int = 0, metrics=None):
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        self._seed = seed
        self._rules: List[FaultRule] = []
        self._injected: Dict[tuple, int] = {}
        self._metrics = metrics

    # -- configuration (admin endpoint) --------------------------------
    def configure(self, spec: Dict) -> None:
        """Replace the rule set atomically. ``{"seed": S, "rules":
        [...]}`` — a new seed restarts the RNG so a matrix run is
        reproducible per (seed, rule set)."""
        rules = [FaultRule.from_dict(r) for r in spec.get("rules") or ()]
        with self._lock:
            if "seed" in spec:
                self._seed = int(spec["seed"])
                self._rng = random.Random(self._seed)
            self._rules = rules

    def add_rule(self, rule: FaultRule) -> None:
        with self._lock:
            self._rules = self._rules + [rule]

    def clear(self) -> None:
        with self._lock:
            self._rules = []

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "seed": self._seed,
                "rules": [r.to_dict() for r in self._rules],
                "injected": {
                    f"{fault}/{resource}": n
                    for (fault, resource), n in sorted(self._injected.items())
                },
            }

    # -- the hot path --------------------------------------------------
    def decide(self, verb: str, resource: str,
               watch: bool = False) -> Optional[FaultRule]:
        """First matching rule that fires, or None. Decisions consume
        the shared RNG under the lock, so a single-threaded request
        sequence replays exactly per seed."""
        if not self._rules:          # steady state: one attribute read
            return None
        with self._lock:
            for rule in self._rules:
                if not rule.matches(verb, resource, watch):
                    continue
                if rule.count is not None and rule.count <= 0:
                    continue
                if rule.probability < 1.0 and \
                        self._rng.random() >= rule.probability:
                    continue
                if rule.count is not None:
                    rule.count -= 1
                key = (rule.fault, resource or "-")
                self._injected[key] = self._injected.get(key, 0) + 1
                metrics = self._metrics
                break
            else:
                return None
        if metrics is None:
            from kubernetes_tpu_torch.metrics.fabric_metrics import fabric_metrics

            metrics = self._metrics = fabric_metrics()
        metrics.faults_injected_total.inc(rule.fault, resource or "-")
        return rule

    def injected_total(self) -> int:
        with self._lock:
            return sum(self._injected.values())
