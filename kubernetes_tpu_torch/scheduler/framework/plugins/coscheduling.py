"""Coscheduling (gang scheduling): a Permit gate and a gang-aware queue
sort. Pods declare a gang with two labels:

    pod-group.scheduling.k8s.io/name: <group>
    pod-group.scheduling.k8s.io/min-available: "<N>"

- Permit wait: a member waits at Permit until N members of its gang are
  scheduled or waiting; the N-th member's arrival allows every waiting
  member.
- Queue sort (``CoschedulingSort``): priority, then the group's anchor
  timestamp (its first member seen), then the group name, so a gang's
  members drain one after another instead of interleaving with another
  gang's, which could leave two half-admitted gangs holding each other's
  room at Permit. Pods of no gang keep PrioritySort's order.
- Whole-gang rejection and backoff: when one member fails after Permit
  (a Permit timeout, a failed bind), every waiting member of its gang is
  rejected with it and the gang backs off (PreFilter fails at once)
  before its next attempt.
"""

import threading
import time
from typing import Dict, Tuple

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.scheduler.framework.interface import (
    UNSCHEDULABLE,
    WAIT,
    PermitPlugin,
    PreFilterPlugin,
    QueueSortPlugin,
    Status,
)
from kubernetes_tpu_torch.scheduler.types import QueuedPodInfo

GROUP_NAME_LABEL = "pod-group.scheduling.k8s.io/name"
MIN_AVAILABLE_LABEL = "pod-group.scheduling.k8s.io/min-available"
DEFAULT_WAIT_SECONDS = 60.0
DEFAULT_GANG_BACKOFF_SECONDS = 5.0


def pod_group(pod: Pod) -> Tuple[str, int]:
    """(group name, min-available) of the pod; ("", 0) for no gang."""
    name = pod.metadata.labels.get(GROUP_NAME_LABEL, "")
    try:
        min_available = int(pod.metadata.labels.get(MIN_AVAILABLE_LABEL, "0"))
    except ValueError:
        min_available = 0
    return name, min_available


class CoschedulingSort(QueueSortPlugin):
    """Queue order (-priority, group anchor, group name, own timestamp).
    The anchor is the timestamp of the group's first member seen, frozen
    from then on: re-keying a group while members sit in the active heap
    would break the heap. At most ``MAX_ANCHORS`` groups are remembered;
    the least recently seen go first, and a queued gang is seen on every
    key computation, so only dead groups are dropped."""

    NAME = "CoschedulingSort"
    MAX_ANCHORS = 4096

    def __init__(self):
        self._lock = threading.Lock()
        # group -> anchor timestamp; insertion order is the recency order
        self._anchors: Dict[str, float] = {}

    @staticmethod
    def factory(args, handle):
        return CoschedulingSort()

    def _anchor(self, qpi: QueuedPodInfo) -> Tuple[float, str]:
        group = qpi.pod.metadata.labels.get(GROUP_NAME_LABEL, "")
        if not group:
            return qpi.timestamp, ""
        with self._lock:
            ts = self._anchors.pop(group, None)
            if ts is None:
                ts = qpi.timestamp
            self._anchors[group] = ts
            if len(self._anchors) > self.MAX_ANCHORS:
                drop = len(self._anchors) - self.MAX_ANCHORS \
                    + self.MAX_ANCHORS // 4
                for g in list(self._anchors)[:drop]:
                    del self._anchors[g]
        return ts, group

    def sort_key(self, qpi: QueuedPodInfo) -> tuple:
        ts, group = self._anchor(qpi)
        return (-qpi.pod.priority(), ts, group, qpi.timestamp)

    def less(self, a: QueuedPodInfo, b: QueuedPodInfo) -> bool:
        return self.sort_key(a) < self.sort_key(b)


class Coscheduling(PermitPlugin, PreFilterPlugin):
    """Arguments: ``permitWaitSeconds`` (how long a member waits for its
    gang, default 60) and ``gangBackoffSeconds`` (how long a gang backs
    off after a failed admission, default 5)."""

    NAME = "Coscheduling"

    @staticmethod
    def factory(args, handle):
        return Coscheduling(handle, args or {})

    def __init__(self, handle=None, args=None):
        self.handle = handle
        args = args or {}
        self.wait_seconds = float(args.get("permitWaitSeconds",
                                           DEFAULT_WAIT_SECONDS))
        self.backoff_seconds = float(args.get("gangBackoffSeconds",
                                              DEFAULT_GANG_BACKOFF_SECONDS))
        self._lock = threading.Lock()
        self._permitted: Dict[str, int] = {}   # group -> pods at or past Permit
        self._backoff_until: Dict[str, float] = {}
        # group -> uids of the members parked at Permit: a release or a
        # rejection looks each up instead of scanning every waiting pod
        self._waiting: Dict[str, set] = {}

    def pre_filter(self, state, pod: Pod):
        """Fail at once while the pod's gang backs off."""
        group, min_available = pod_group(pod)
        if not group or min_available <= 1:
            return None
        with self._lock:
            until = self._backoff_until.get(group, 0.0)
        if time.monotonic() < until:
            return Status(UNSCHEDULABLE,
                          f"gang {group} backing off after a failed admission")
        return None

    def permit(self, state, pod: Pod, node_name: str):
        group, min_available = pod_group(pod)
        if not group or min_available <= 1:
            return None, 0.0
        with self._lock:
            self._permitted[group] = self._permitted.get(group, 0) + 1
            if self._permitted[group] >= min_available:
                members = self._waiting.pop(group, set())
            else:
                self._waiting.setdefault(group, set()).add(pod.uid)
                members = None
        if members is not None:
            for uid in members:
                wp = self.handle.get_waiting_pod(uid)
                if wp is not None:
                    wp.allow(self.NAME)
            return None, 0.0
        # wake siblings parked unschedulable or in backoff: the gang
        # completes only when its members overlap at Permit
        nominator = getattr(self.handle, "pod_nominator", None)
        if nominator is not None and hasattr(nominator, "gang_members_added"):
            nominator.gang_members_added({group})
        return Status(WAIT, f"waiting for gang {group}"), self.wait_seconds

    def note_member_deleted(self, pod: Pod) -> None:
        """A bound member was deleted: release its arrival slot, so a gang
        created again under the same name waits at Permit from zero. A
        group at zero drops its bookkeeping."""
        group, _ = pod_group(pod)
        if not group:
            return
        with self._lock:
            left = self._permitted.get(group)
            if left is not None:
                left -= 1
                if left <= 0:
                    self._permitted.pop(group, None)
                    self._backoff_until.pop(group, None)
                else:
                    self._permitted[group] = left

    def unreserve_group(self, pod: Pod) -> None:
        """A member failed after Permit: undo its arrival, reject every
        member still waiting at Permit, and start the gang's backoff."""
        group, _ = pod_group(pod)
        if not group:
            return
        with self._lock:
            left = self._permitted.get(group, 0) - 1
            if left > 0:
                self._permitted[group] = left
            else:
                self._permitted.pop(group, None)
            if self.backoff_seconds > 0:
                self._backoff_until[group] = (time.monotonic()
                                              + self.backoff_seconds)
                if len(self._backoff_until) > 1024:
                    now = time.monotonic()
                    self._backoff_until = {
                        g: t for g, t in self._backoff_until.items()
                        if t > now}
            members = self._waiting.pop(group, set())
            members.discard(pod.uid)
        if self.handle is None:
            return
        for uid in members:
            wp = self.handle.get_waiting_pod(uid)
            if wp is not None:
                wp.reject(self.NAME,
                          f"gang {group} member {pod.name} failed admission")
