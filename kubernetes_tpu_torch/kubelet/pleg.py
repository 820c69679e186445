"""PLEG — Pod Lifecycle Event Generator (reference
``pkg/kubelet/pleg/generic.go:110 NewGenericPLEG`` + ``relist``): the
kubelet's second eye on the world. The watch path tells it what the API
WANTS; the PLEG periodically relists the container RUNTIME and turns
state deltas into pod-scoped lifecycle events (ContainerStarted /
ContainerDied / ContainerRemoved), which the sync loop consumes to
reconcile pods whose containers changed underneath it — a crashed
container is observed here, not via the apiserver.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

CONTAINER_STARTED = "ContainerStarted"
CONTAINER_DIED = "ContainerDied"
CONTAINER_REMOVED = "ContainerRemoved"


@dataclass
class PodLifecycleEvent:
    pod_uid: str
    type: str
    data: str = ""  # container id


class PLEG:
    """Generic PLEG over the CRI runtime service. ``relist`` diffs the
    current container states against the previous relist (generic.go
    relist: computeEvents per pod) and hands each event to the sink
    (the kubelet marks the pod dirty); ``relist_period`` matches the
    reference's 1s GenericPLEG tick when driven by ``start``, but the
    kubelet may also call ``relist`` inline from its sync loop."""

    def __init__(self, runtime, sink: Callable[[PodLifecycleEvent], None],
                 relist_period: float = 1.0):
        self.runtime = runtime
        self.sink = sink
        self.relist_period = relist_period
        # (pod uid, container id) -> state at last relist
        self._last: Dict[Tuple[str, str], str] = {}
        self._last_relist: float = 0.0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.events_emitted = 0  # observability

    # -- the core -------------------------------------------------------
    def relist(self) -> List[PodLifecycleEvent]:
        """One relist pass; returns (and sinks) the generated events."""
        current: Dict[Tuple[str, str], str] = {}
        for sandbox in self.runtime.list_pod_sandboxes():
            for cs in self.runtime.list_containers(sandbox.id):
                current[(sandbox.pod_uid, cs.id)] = cs.state
        events: List[PodLifecycleEvent] = []
        with self._lock:
            for key, state in current.items():
                old = self._last.get(key)
                if old == state:
                    continue
                uid, cid = key
                if state == "RUNNING":
                    events.append(PodLifecycleEvent(
                        uid, CONTAINER_STARTED, cid))
                elif state in ("EXITED", "UNKNOWN"):
                    # ANY transition into exited generates ContainerDied
                    # (generic.go generateEvents) — including a container
                    # that started AND crashed between two relists
                    # (old CREATED or first sighting), or the pod never
                    # re-syncs and a crash-loop sits EXITED forever
                    events.append(PodLifecycleEvent(
                        uid, CONTAINER_DIED, cid))
            for key in self._last:
                if key not in current:
                    events.append(PodLifecycleEvent(
                        key[0], CONTAINER_REMOVED, key[1]))
            self._last = current
            self._last_relist = time.monotonic()
        for ev in events:
            self.events_emitted += 1
            try:
                self.sink(ev)
            except Exception:  # noqa: BLE001 — sink must not kill relist
                pass
        return events

    def healthy(self, threshold: float = 180.0) -> bool:
        """generic.go Healthy(): the PLEG is unhealthy when relist
        hasn't completed within the threshold (3m in the reference) —
        surfaced through the node's Ready condition."""
        with self._lock:
            last = self._last_relist
        return last == 0.0 or (time.monotonic() - last) < threshold

    # -- optional self-driving loop ------------------------------------
    def start(self) -> "PLEG":
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="pleg")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _loop(self) -> None:
        while not self._stop.wait(self.relist_period):
            try:
                self.relist()
            except Exception:  # noqa: BLE001
                pass
