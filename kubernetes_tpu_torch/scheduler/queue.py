"""The scheduling queue: an active heap in the QueueSort plugin's order,
a backoff heap (exponential 1 s to 10 s) and the unschedulable set,
with the scheduling-cycle / move-request-cycle protocol that decides
whether a failed pod parks or backs off, and the pod nominator that
holds preemption's nominations.

The heap orders by a cached total-order key, the QueueSort plugin's
(PrioritySort's (-priority, enqueue timestamp) until the scheduler sets
its profile's); equal keys keep the heap's own array order, and the
batch drain sorts the whole heap stably by the same key. A new member of
a coscheduling gang wakes its parked siblings (``gang_members_added``)."""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.observability.tracer import get_tracer
from kubernetes_tpu_torch.scheduler.framework.plugins.coscheduling import (
    GROUP_NAME_LABEL,
)
from kubernetes_tpu_torch.scheduler.framework.plugins.queue_sort import (
    PrioritySort,
)
from kubernetes_tpu_torch.scheduler.types import (
    PodInfo,
    QueuedPodInfo,
    get_pod_key,
)

POD_INITIAL_BACKOFF = 1.0
POD_MAX_BACKOFF = 10.0
UNSCHEDULABLE_Q_TIME_INTERVAL = 60.0

# the cluster events that move unschedulable pods back to an attempt
NODE_ADD = "NodeAdd"
NODE_ALLOCATABLE_CHANGE = "NodeAllocatableChange"
NODE_LABEL_CHANGE = "NodeLabelChange"
NODE_TAINT_CHANGE = "NodeTaintChange"
NODE_SPEC_UNSCHEDULABLE_CHANGE = "NodeSpecUnschedulableChange"
ASSIGNED_POD_DELETE = "AssignedPodDelete"
UNSCHEDULABLE_TIMEOUT = "UnschedulableTimeout"
PV_ADD = "PvAdd"
PV_UPDATE = "PvUpdate"
PVC_ADD = "PvcAdd"
PVC_UPDATE = "PvcUpdate"
STORAGE_CLASS_ADD = "StorageClassAdd"
CSI_NODE_ADD = "CSINodeAdd"
CSI_NODE_UPDATE = "CSINodeUpdate"
SERVICE_ADD = "ServiceAdd"
SERVICE_UPDATE = "ServiceUpdate"


class PodNominator:
    """Node name -> the pods nominated to it by preemption. The queue's
    add, update, delete and requeue paths keep it current."""

    def __init__(self):
        self._lock = threading.RLock()
        self._nominated: Dict[str, List[PodInfo]] = {}
        self._pod_to_node: Dict[str, str] = {}

    def add_nominated_pod(self, pod: Pod, node_name: str = "") -> None:
        """Nominate ``pod`` to ``node_name`` (default: the pod's own
        ``status.nominated_node_name``; none drops the nomination)."""
        with self._lock:
            self._delete_locked(pod)
            nn = node_name or pod.status.nominated_node_name
            if not nn:
                return
            self._pod_to_node[get_pod_key(pod)] = nn
            self._nominated.setdefault(nn, []).append(PodInfo(pod))

    def delete_nominated_pod_if_exists(self, pod: Pod) -> None:
        with self._lock:
            self._delete_locked(pod)

    def update_nominated_pod(self, old: Pod, new: Pod) -> None:
        with self._lock:
            # an update that drops the status field keeps the nomination
            nn = self._pod_to_node.get(get_pod_key(old), "")
            self._delete_locked(old)
            self.add_nominated_pod(new, new.status.nominated_node_name or nn)

    def nominated_pods_for_node(self, node_name: str) -> List[PodInfo]:
        with self._lock:
            return list(self._nominated.get(node_name, ()))

    def _delete_locked(self, pod: Pod) -> None:
        key = get_pod_key(pod)
        nn = self._pod_to_node.pop(key, None)
        if nn is not None and nn in self._nominated:
            self._nominated[nn] = [pi for pi in self._nominated[nn]
                                   if get_pod_key(pi.pod) != key]
            if not self._nominated[nn]:
                del self._nominated[nn]


class Heap:
    """Keyed binary heap over a cached total-order key."""

    def __init__(self, key_func: Callable[[Any], str],
                 sort_key: Callable[[Any], Any]):
        self._key = key_func
        self._sort_key = sort_key
        self._items: List[Any] = []
        self._okeys: List[Any] = []
        self._index: Dict[str, int] = {}

    def __len__(self) -> int:
        return len(self._items)

    def has_key(self, key: str) -> bool:
        return key in self._index

    def list(self) -> List[Any]:
        return list(self._items)

    def set_sort_key(self, sort_key: Callable[[Any], Any]) -> None:
        """Order by ``sort_key`` from now on; only on an empty heap (the
        items held were sifted by the old key)."""
        if self._items:
            raise ValueError("set_sort_key requires an empty heap")
        self._sort_key = sort_key

    def get_by_key(self, key: str) -> Optional[Any]:
        i = self._index.get(key)
        return self._items[i] if i is not None else None

    def add(self, obj: Any) -> None:
        """Insert, or update in place when the key is present."""
        key = self._key(obj)
        if key in self._index:
            i = self._index[key]
            self._items[i] = obj
            self._okeys[i] = self._sort_key(obj)
            self._sift_up(i)
            self._sift_down(i)
        else:
            self._items.append(obj)
            self._okeys.append(self._sort_key(obj))
            self._index[key] = len(self._items) - 1
            self._sift_up(len(self._items) - 1)

    def delete_by_key(self, key: str) -> bool:
        i = self._index.get(key)
        if i is None:
            return False
        self._swap(i, len(self._items) - 1)
        self._items.pop()
        self._okeys.pop()
        del self._index[key]
        if i < len(self._items):
            self._sift_up(i)
            self._sift_down(i)
        return True

    def pop_all(self) -> List[Any]:
        """Remove and return every item, in heap array order."""
        items = self._items
        self._items, self._okeys, self._index = [], [], {}
        return items

    def replace_all(self, items_in_heap_order: List[Any]) -> None:
        """Install items that already satisfy the heap property (a sorted
        list does); no sifting."""
        self._items = list(items_in_heap_order)
        self._okeys = [self._sort_key(o) for o in self._items]
        self._index = {self._key(o): i for i, o in enumerate(self._items)}

    def peek(self) -> Optional[Any]:
        return self._items[0] if self._items else None

    def pop(self) -> Any:
        top = self._items[0]
        self.delete_by_key(self._key(top))
        return top

    def _swap(self, i: int, j: int) -> None:
        if i == j:
            return
        items, okeys = self._items, self._okeys
        items[i], items[j] = items[j], items[i]
        okeys[i], okeys[j] = okeys[j], okeys[i]
        self._index[self._key(items[i])] = i
        self._index[self._key(items[j])] = j

    def _sift_up(self, i: int) -> None:
        while i > 0:
            parent = (i - 1) // 2
            if self._okeys[i] < self._okeys[parent]:
                self._swap(i, parent)
                i = parent
            else:
                break

    def _sift_down(self, i: int) -> None:
        n = len(self._items)
        while True:
            smallest = i
            for child in (2 * i + 1, 2 * i + 2):
                if child < n and self._okeys[child] < self._okeys[smallest]:
                    smallest = child
            if smallest == i:
                return
            self._swap(i, smallest)
            i = smallest


class SchedulingQueue(PodNominator):
    """``metrics`` (a ``SchedulerMetrics``) counts the pods added to each
    queue and moved by each event; each popped pod that the process
    tracer samples gets a ``queue.wait`` span (enqueue to pop). A pod's
    backoff doubles from ``pod_initial_backoff`` seconds each attempt, up
    to ``pod_max_backoff``."""

    def __init__(self, metrics=None,
                 pod_initial_backoff: float = POD_INITIAL_BACKOFF,
                 pod_max_backoff: float = POD_MAX_BACKOFF):
        super().__init__()
        self._metrics = metrics
        self.pod_initial_backoff = pod_initial_backoff
        self.pod_max_backoff = pod_max_backoff
        self._now = time.monotonic
        self._cond = threading.Condition(threading.RLock())

        def key(qpi: QueuedPodInfo) -> str:
            return get_pod_key(qpi.pod)

        self.sort_key: Callable[[QueuedPodInfo], Any] = PrioritySort.sort_key
        self._active_q = Heap(key, self.sort_key)
        self._backoff_q = Heap(key, self._backoff_time)
        self._unschedulable_q: Dict[str, QueuedPodInfo] = {}
        self.scheduling_cycle = 0
        self._move_request_cycle = -1
        # event -> pods it moved out of the unschedulable set
        self.pods_moved: Dict[str, int] = {}

    def set_sort_key(self, sort_key: Callable[[QueuedPodInfo], Any]
                     ) -> None:
        """Order the active queue by the QueueSort plugin's total-order
        key; only while it is empty."""
        with self._cond:
            self._active_q.set_sort_key(sort_key)
            self.sort_key = sort_key

    # ------------------------------------------------------------------
    def _backoff_time(self, qpi: QueuedPodInfo) -> float:
        return qpi.timestamp + self._backoff_duration(qpi)

    def _backoff_duration(self, qpi: QueuedPodInfo) -> float:
        """initial * 2^(attempts-1), capped at the maximum."""
        d, cap = self.pod_initial_backoff, self.pod_max_backoff
        for _ in range(1, qpi.attempts):
            d *= 2
            if d >= cap:
                return cap
        return min(d, cap)

    def _backoff_complete(self, qpi: QueuedPodInfo) -> bool:
        return self._now() >= self._backoff_time(qpi)

    def _new_queued_pod_info(self, pod: Pod) -> QueuedPodInfo:
        # a pod already queued keeps its attempts across hops
        key = get_pod_key(pod)
        for source in (self._active_q.get_by_key(key),
                       self._backoff_q.get_by_key(key),
                       self._unschedulable_q.get(key)):
            if source is not None:
                source.pod_info = PodInfo(pod)
                source.timestamp = self._now()
                return source
        return QueuedPodInfo(pod, timestamp=self._now())

    # ------------------------------------------------------------------
    def add_many(self, pods: List[Pod]) -> None:
        """Enqueue pending pods under one lock and one wakeup."""
        if not pods:
            return
        with self._cond:
            for pod in pods:
                qpi = self._new_queued_pod_info(pod)
                self._active_q.add(qpi)
                key = get_pod_key(pod)
                self._unschedulable_q.pop(key, None)
                self._backoff_q.delete_by_key(key)
                self.add_nominated_pod(pod)
            if self._metrics:
                self._metrics.pods_added("active", "PodAdd",
                                         amount=len(pods))
            self._cond.notify_all()

    def update(self, old: Optional[Pod], new: Pod) -> None:
        """A pending pod changed: refresh it where it waits. A parked pod
        whose update may make it schedulable goes back to an attempt; a
        pod in no queue is added."""
        with self._cond:
            key = get_pod_key(new)
            if old is not None:
                for q in (self._active_q, self._backoff_q):
                    existing = q.get_by_key(key)
                    if existing is not None:
                        existing.pod_info = PodInfo(new)
                        q.add(existing)
                        self.update_nominated_pod(old, new)
                        return
            existing = self._unschedulable_q.get(key)
            if existing is not None:
                self.update_nominated_pod(old or existing.pod, new)
                existing.pod_info = PodInfo(new)
                if old is not None and _pod_updated_may_help(old, new):
                    del self._unschedulable_q[key]
                    if self._backoff_complete(existing):
                        self._active_q.add(existing)
                        self._cond.notify_all()
                    else:
                        self._backoff_q.add(existing)
                return
            self._active_q.add(self._new_queued_pod_info(new))
            self.add_nominated_pod(new)
            self._cond.notify_all()

    def delete(self, pod: Pod) -> None:
        self.delete_many([pod])

    def delete_many(self, pods: List[Pod]) -> None:
        with self._cond:
            for pod in pods:
                key = get_pod_key(pod)
                self.delete_nominated_pod_if_exists(pod)
                self._active_q.delete_by_key(key)
                self._backoff_q.delete_by_key(key)
                self._unschedulable_q.pop(key, None)

    def add_unschedulable_if_not_present(self, qpi: QueuedPodInfo,
                                         pod_scheduling_cycle: int,
                                         prefer_backoff: bool = False
                                         ) -> None:
        """Requeue a pod whose cycle failed: to backoff when a move request
        arrived during that cycle (the cluster may already have changed)
        or when ``prefer_backoff`` (a scheduler error is no evidence the
        pod does not fit), else to the unschedulable set until an event
        moves it."""
        with self._cond:
            key = get_pod_key(qpi.pod)
            if (key in self._unschedulable_q or self._active_q.has_key(key)
                    or self._backoff_q.has_key(key)):
                raise ValueError(f"pod {key} already present in a queue")
            qpi.timestamp = self._now()
            if prefer_backoff \
                    or self._move_request_cycle >= pod_scheduling_cycle:
                self._backoff_q.add(qpi)
                if self._metrics:
                    self._metrics.pods_added("backoff",
                                             "ScheduleAttemptFailure")
            else:
                self._unschedulable_q[key] = qpi
                if self._metrics:
                    self._metrics.pods_added("unschedulable",
                                             "ScheduleAttemptFailure")
            self.add_nominated_pod(qpi.pod)
            self._cond.notify_all()

    def pop_batch(self, max_n: int, timeout: Optional[float] = None
                  ) -> Tuple[List[QueuedPodInfo], int]:
        """Pop up to ``max_n`` pods in queue order under one lock: the
        whole active heap is drained and sorted by the queue key
        (computed afresh: ``CoschedulingSort`` notes each group it sees),
        the remainder goes back. Each popped pod consumes one scheduling
        cycle; returns (pods, cycle of the first pop)."""
        with self._cond:
            while len(self._active_q) == 0:
                if not self._cond.wait(timeout):
                    return [], self.scheduling_cycle
            n = min(max_n, len(self._active_q))
            items = self._active_q.pop_all()
            items.sort(key=self.sort_key)
            if len(items) > n:
                self._active_q.replace_all(items[n:])
                items = items[:n]
            for qpi in items:
                qpi.attempts += 1
            first_cycle = self.scheduling_cycle + 1
            self.scheduling_cycle += len(items)
        self._trace_popped(items)
        return items, first_cycle

    def _trace_popped(self, items: List[QueuedPodInfo]) -> None:
        """A ``queue.wait`` span (enqueue to pop) for each sampled popped
        pod, outside the queue lock; both ends on the queue's clock."""
        tracer = get_tracer()
        if not tracer.enabled:
            return
        now = self._now()
        for qpi in items:
            uid = qpi.pod.uid
            if uid and tracer.sampled(uid):
                tracer.record("queue.wait", qpi.timestamp, now, trace=uid,
                              attempts=qpi.attempts)

    # ------------------------------------------------------------------
    def move_all_to_active_or_backoff_queue(self, event: str) -> None:
        """Every unschedulable pod gets another attempt after ``event``
        (to backoff while its backoff runs)."""
        with self._cond:
            self._move_pods_locked(list(self._unschedulable_q.values()),
                                   event)

    def gang_members_added(self, groups) -> None:
        """A new (or requeued) member of a coscheduling gang wakes its
        siblings: members of ``groups`` (group names) parked unschedulable
        or in backoff go straight to the active queue, backoff or not,
        since a gang completes only when its members overlap at Permit.
        The move-request cycle advances, so a member failing in a cycle
        under way backs off instead of parking."""
        if not groups:
            return

        def in_groups(qpi: QueuedPodInfo) -> bool:
            return qpi.pod.metadata.labels.get(GROUP_NAME_LABEL, "") \
                in groups

        with self._cond:
            moved = False
            for qpi in [q for q in self._unschedulable_q.values()
                        if in_groups(q)]:
                self._unschedulable_q.pop(get_pod_key(qpi.pod), None)
                self._active_q.add(qpi)
                moved = True
            for qpi in [q for q in self._backoff_q.list() if in_groups(q)]:
                self._backoff_q.delete_by_key(get_pod_key(qpi.pod))
                self._active_q.add(qpi)
                moved = True
            self._move_request_cycle = self.scheduling_cycle
            if moved:
                self._cond.notify_all()

    def assigned_pods_updated(self, pods: List[Pod]) -> None:
        """Wake unschedulable pods whose (anti-)affinity terms match a
        newly assigned pod."""
        with self._cond:
            if not self._unschedulable_q:
                # the move-request cycle advances even when nothing moves
                self._move_request_cycle = self.scheduling_cycle
                return
            for pod in pods:
                self._move_pods_locked(
                    self._unschedulable_pods_with_matching_affinity(pod),
                    "AssignedPodUpdate")

    def _unschedulable_pods_with_matching_affinity(
            self, pod: Pod) -> List[QueuedPodInfo]:
        out = []
        for qpi in self._unschedulable_q.values():
            pi = qpi.pod_info
            terms = (pi.required_affinity_terms
                     + pi.required_anti_affinity_terms
                     + [wt.term for wt in pi.preferred_affinity_terms]
                     + [wt.term for wt in pi.preferred_anti_affinity_terms])
            if any(t.matches(pod) for t in terms):
                out.append(qpi)
        return out

    def _move_pods_locked(self, pods: List[QueuedPodInfo],
                          event: str) -> None:
        if pods:
            self.pods_moved[event] = self.pods_moved.get(event, 0) + len(pods)
            if self._metrics:
                self._metrics.pods_moved(event, amount=len(pods))
        for qpi in pods:
            if self._backoff_complete(qpi):
                self._active_q.add(qpi)
            else:
                self._backoff_q.add(qpi)
            self._unschedulable_q.pop(get_pod_key(qpi.pod), None)
        self._move_request_cycle = self.scheduling_cycle
        self._cond.notify_all()

    def flush_backoff_completed(self) -> None:
        with self._cond:
            moved = False
            while len(self._backoff_q):
                top = self._backoff_q.peek()
                if not self._backoff_complete(top):
                    break
                self._backoff_q.pop()
                self._active_q.add(top)
                moved = True
            if moved:
                self._cond.notify_all()

    def flush_unschedulable_left_over(self) -> None:
        with self._cond:
            now = self._now()
            stale = [qpi for qpi in self._unschedulable_q.values()
                     if now - qpi.timestamp >= UNSCHEDULABLE_Q_TIME_INTERVAL]
            if stale:
                self._move_pods_locked(stale, UNSCHEDULABLE_TIMEOUT)

    def unschedulable_pods(self) -> List[Pod]:
        """The parked unschedulable pods: each failed a cycle as
        Unschedulable and waits for a cluster event (the cluster
        autoscaler's trigger set)."""
        with self._cond:
            return [q.pod for q in self._unschedulable_q.values()]

    def pending_pods(self) -> List[Pod]:
        """Every queued pod: active, backing off and unschedulable."""
        with self._cond:
            return ([q.pod for q in self._active_q.list()]
                    + [q.pod for q in self._backoff_q.list()]
                    + [q.pod for q in self._unschedulable_q.values()])

    def pending_active_count(self) -> int:
        """Pods still due an attempt (active + backoff)."""
        with self._cond:
            return len(self._active_q) + len(self._backoff_q)

    def num_active(self) -> int:
        with self._cond:
            return len(self._active_q)

    def pending_hint(self) -> Tuple[int, Optional[int]]:
        """Without popping or waiting: the active queue's size and the
        priority of the pod a pop would return first ((0, None) when
        empty). Advisory only; the queue may change before the caller
        acts on it."""
        with self._cond:
            if not len(self._active_q):
                return 0, None
            return len(self._active_q), self._active_q.peek().pod.priority()


def _pod_updated_may_help(old: Pod, new: Pod) -> bool:
    """Whether a pending pod's update may change its verdict."""
    return (old.metadata.labels != new.metadata.labels
            or old.spec.node_selector != new.spec.node_selector
            or old.spec.tolerations != new.spec.tolerations
            or old.spec.priority != new.spec.priority
            or old.spec.affinity != new.spec.affinity)
