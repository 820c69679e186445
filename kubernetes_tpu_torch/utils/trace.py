"""Step traces of the serial path (``k8s.io/utils/trace``): a trace
with steps, logged only when its total exceeds a threshold. Each trace
also records a span (``trace.<name>``, its steps as instants) into the
process tracer, keyed by the pod's uid and head-sampled like every
per-pod span. Steps are sorted by time before their deltas are logged."""

from __future__ import annotations

import logging
import time
from typing import List, Tuple

from kubernetes_tpu_torch.observability.tracer import get_tracer

logger = logging.getLogger("kubernetes_tpu_torch.trace")


class Trace:
    def __init__(self, name: str, **fields):
        self.name = name
        self.fields = fields
        self.start = time.monotonic()
        self.steps: List[Tuple[float, str]] = []
        self._recorded = False

    def step(self, msg: str) -> None:
        self.steps.append((time.monotonic(), msg))

    def _record_span(self, end: float) -> None:
        """Record this trace into the tracer, once."""
        if self._recorded:
            return
        self._recorded = True
        tracer = get_tracer()
        if not tracer.enabled:
            return
        uid = str(self.fields.get("uid", ""))
        if uid and not tracer.sampled(uid):
            return
        tracer.record(f"trace.{self.name}", self.start, end, trace=uid,
                      steps=len(self.steps),
                      pod=str(self.fields.get("pod", "")))
        for ts, msg in self.steps:
            tracer.event(f"step.{msg}", trace=uid, at_mono=ts)

    def log_if_long(self, threshold: float) -> None:
        now = time.monotonic()
        self._record_span(now)
        total = now - self.start
        if total < threshold:
            return
        parts = [f'"{self.name}" {self.fields} total={total * 1000:.1f}ms']
        prev = self.start
        for ts, msg in sorted(self.steps):
            parts.append(f"  step {msg}: +{(ts - prev) * 1000:.1f}ms")
            prev = ts
        logger.info("\n".join(parts))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._record_span(time.monotonic())
        return False
