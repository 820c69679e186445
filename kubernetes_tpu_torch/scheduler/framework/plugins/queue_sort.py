"""PrioritySort QueueSort plugin (reference
``plugins/queuesort/priority_sort.go:41-45``): higher ``.spec.priority``
first, earlier queue timestamp as tiebreak."""

from kubernetes_tpu_torch.scheduler.framework.interface import QueueSortPlugin
from kubernetes_tpu_torch.scheduler.types import QueuedPodInfo


class PrioritySort(QueueSortPlugin):
    NAME = "PrioritySort"

    @staticmethod
    def factory(args, handle):
        return PrioritySort()

    def less(self, a: QueuedPodInfo, b: QueuedPodInfo) -> bool:
        pa, pb = a.pod.priority(), b.pod.priority()
        if pa != pb:
            return pa > pb
        return a.timestamp < b.timestamp

    @staticmethod
    def sort_key(qpi: QueuedPodInfo) -> tuple:
        """Total-order key equivalent of ``less`` (ascending sort puts
        the queue head first). Enables the queue's bulk C-sorted drain."""
        return (-qpi.pod.priority(), qpi.timestamp)
