"""Per-scheduling-cycle key-value state: the PreFilter -> Filter data
handoff, cloned for preemption dry runs, and the flag that samples
per-plugin metrics on about 10% of serial cycles."""

from __future__ import annotations

import copy
from typing import Any, Dict


class CycleState:
    __slots__ = ("_storage", "record_plugin_metrics")

    def __init__(self):
        self._storage: Dict[str, Any] = {}
        self.record_plugin_metrics = False

    def read(self, key: str) -> Any:
        if key not in self._storage:
            raise KeyError(f"{key} not found in CycleState")
        return self._storage[key]

    def write(self, key: str, value: Any) -> None:
        self._storage[key] = value

    def delete(self, key: str) -> None:
        self._storage.pop(key, None)

    def clone(self) -> "CycleState":
        c = CycleState()
        c.record_plugin_metrics = self.record_plugin_metrics
        for k, v in self._storage.items():
            clone_fn = getattr(v, "clone", None)
            c._storage[k] = clone_fn() if callable(clone_fn) else copy.copy(v)
        return c
