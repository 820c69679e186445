"""DefaultBinder (reference ``plugins/defaultbinder/default_binder.go:50-61``):
issues the Binding — the equivalent of POST pods/{name}/binding — through
the client."""

from typing import Optional

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.scheduler.framework.interface import BindPlugin, Status


class DefaultBinder(BindPlugin):
    NAME = "DefaultBinder"

    @staticmethod
    def factory(args, handle):
        return DefaultBinder(handle)

    def __init__(self, handle=None):
        self.handle = handle

    def bind(self, state, pod: Pod, node_name: str) -> Optional[Status]:
        try:
            self.handle.client.bind(pod.namespace, pod.name, pod.uid, node_name)
        except Exception as e:  # surface as Error status like the reference
            return Status(1, str(e))
        return None

    def bind_many(self, states, pods, node_names) -> list:
        """Bulk Binding for the batch commit path: one ``bind_many`` call
        to the store (one lock + one batched watch delivery) instead of
        N round-trips. Each binding remains its own transaction; per-pod
        failures come back positionally as Error statuses."""
        try:
            errors = self.handle.client.bind_many([
                (p.namespace, p.name, p.uid, node)
                for p, node in zip(pods, node_names)
            ])
        except Exception as e:  # noqa: BLE001 — batch-level failure (e.g.
            # a watcher raising during the synchronous dispatch) must
            # surface as per-pod Error statuses, like serial bind's
            # try/except, so the caller unwinds instead of stranding
            # assumed pods
            return [Status(1, str(e))] * len(pods)
        return [None if e is None else Status(1, str(e)) for e in errors]
