"""Liveness/readiness probing.

Behavioral equivalent of the reference's prober subsystem
(``pkg/kubelet/prober/prober_manager.go`` + ``worker.go``): one worker per
(pod, container, probe-type), periodic probe with initial delay and
failure/success thresholds; readiness results feed the pod's Ready
condition, liveness failures tell the kubelet to restart the container.
Probes here are callables (the fake-CRI analog of exec/http/tcp handlers).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

LIVENESS, READINESS = "liveness", "readiness"
SUCCESS, FAILURE = "success", "failure"


@dataclass
class ProbeSpec:
    probe: Callable[[], bool]
    period: float = 1.0
    initial_delay: float = 0.0
    failure_threshold: int = 3
    success_threshold: int = 1


@dataclass
class _WorkerState:
    result: str = SUCCESS
    consecutive_failures: int = 0
    consecutive_successes: int = 0


class ProbeManager:
    """Synchronous-tick design: the kubelet's sync loop calls ``tick()``;
    deterministic under test clocks, no per-probe threads (the reference
    uses goroutine workers; a tick loop is the idiomatic single-threaded
    recast)."""

    def __init__(self, clock=None):
        from kubernetes_tpu_torch.utils.clock import RealClock

        self._clock = clock or RealClock()
        self._lock = threading.Lock()
        # (pod_uid, container, kind) -> (spec, state, registered_at, last_run)
        self._workers: Dict[Tuple[str, str, str], list] = {}

    def add(self, pod_uid: str, container: str, kind: str, spec: ProbeSpec) -> None:
        with self._lock:
            self._workers[(pod_uid, container, kind)] = [
                spec, _WorkerState(), self._clock.now(), None
            ]

    def remove_pod(self, pod_uid: str) -> None:
        with self._lock:
            for k in [k for k in self._workers if k[0] == pod_uid]:
                del self._workers[k]

    def tick(self) -> None:
        """Run every due probe once; updates results by thresholds."""
        now = self._clock.now()
        with self._lock:
            due = []
            for key, rec in self._workers.items():
                spec, state, registered, last = rec
                if now - registered < spec.initial_delay:
                    continue
                if last is not None and now - last < spec.period:
                    continue
                rec[3] = now
                due.append((key, spec, state))
        for key, spec, state in due:
            try:
                ok = bool(spec.probe())
            except Exception:
                ok = False
            if ok:
                state.consecutive_successes += 1
                state.consecutive_failures = 0
                if state.consecutive_successes >= spec.success_threshold:
                    state.result = SUCCESS
            else:
                state.consecutive_failures += 1
                state.consecutive_successes = 0
                if state.consecutive_failures >= spec.failure_threshold:
                    state.result = FAILURE

    def result(self, pod_uid: str, container: str, kind: str) -> Optional[str]:
        with self._lock:
            rec = self._workers.get((pod_uid, container, kind))
            return rec[1].result if rec else None

    def pod_ready(self, pod_uid: str) -> bool:
        """All readiness probes of the pod pass (no probes → ready)."""
        with self._lock:
            for (uid, _c, kind), rec in self._workers.items():
                if uid == pod_uid and kind == READINESS and rec[1].result != SUCCESS:
                    return False
            return True

    def liveness_failed(self, pod_uid: str) -> Dict[str, bool]:
        """container -> liveness currently failing."""
        with self._lock:
            return {
                c: rec[1].result == FAILURE
                for (uid, c, kind), rec in self._workers.items()
                if uid == pod_uid and kind == LIVENESS
            }
