"""HTTP scheduler extenders (upstream ``pkg/scheduler/core/extender.go``):
the out-of-process webhook protocol, Filter, Prioritize, Bind and
ProcessPreemption as JSON POSTs to ``urlPrefix/<verb>``, called one
extender after another behind the in-tree filters and scores of the
serial path (``scheduler/core.py``). A pod an extender is interested in
never takes the batch path (``sidecar.py``).

``Extender.implementation`` is an object that takes the verbs' payloads
in process; otherwise the verbs go over HTTP (``urllib.request``, which
rides on ``http.client``) with the extender's ``http_timeout``. A failed
call raises; the caller skips an ``ignorable`` extender's failure and
fails the pod otherwise.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Dict, List, Tuple

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.config.types import Extender as ExtenderConfig
from kubernetes_tpu_torch.scheduler.types import NodeInfo


class ExtenderError(Exception):
    pass


class HTTPExtender:
    def __init__(self, config: ExtenderConfig):
        self.config = config
        self.weight = config.weight

    def is_ignorable(self) -> bool:
        return self.config.ignorable

    def is_interested(self, pod: Pod) -> bool:
        return self.config.is_interested(pod)

    def is_binder(self) -> bool:
        return bool(self.config.bind_verb) or (
            self.config.implementation is not None
            and hasattr(self.config.implementation, "bind")
        )

    def supports_preemption(self) -> bool:
        return bool(self.config.preempt_verb) or (
            self.config.implementation is not None
            and hasattr(self.config.implementation, "process_preemption")
        )

    # ------------------------------------------------------------------
    def _call(self, verb: str, payload: dict) -> dict:
        impl = self.config.implementation
        if impl is not None:
            return getattr(impl, verb)(payload)
        path = {"filter": self.config.filter_verb,
                "prioritize": self.config.prioritize_verb,
                "bind": self.config.bind_verb,
                "process_preemption": self.config.preempt_verb}[verb]
        url = f"{self.config.url_prefix.rstrip('/')}/{path}"
        req = urllib.request.Request(
            url,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.config.http_timeout) as resp:
            return json.loads(resp.read().decode())

    # ------------------------------------------------------------------
    def filter(
        self, pod: Pod, nodes: List[NodeInfo]
    ) -> Tuple[List[NodeInfo], Dict[str, str]]:
        """Returns (feasible nodes, failed nodes map name->reason)."""
        if not (self.config.filter_verb or self.config.implementation):
            return nodes, {}
        payload = {
            "pod": _pod_to_dict(pod),
            "nodenames": [ni.node.name for ni in nodes if ni.node is not None],
        }
        result = self._call("filter", payload)
        if result.get("error"):
            raise ExtenderError(result["error"])
        failed = dict(result.get("failedNodes") or {})
        keep = result.get("nodenames")
        if keep is None:
            feasible = [
                ni for ni in nodes
                if ni.node is not None and ni.node.name not in failed
            ]
        else:
            keep_set = set(keep)
            feasible = [
                ni for ni in nodes
                if ni.node is not None and ni.node.name in keep_set
            ]
        return feasible, failed

    def prioritize(
        self, pod: Pod, nodes: List[NodeInfo]
    ) -> Dict[str, float]:
        """Returns node -> weighted score contribution."""
        if not (self.config.prioritize_verb or self.config.implementation):
            return {}
        payload = {
            "pod": _pod_to_dict(pod),
            "nodenames": [ni.node.name for ni in nodes if ni.node is not None],
        }
        result = self._call("prioritize", payload)
        return {
            item["host"]: float(item["score"]) * self.weight
            for item in (result or [])
        } if isinstance(result, list) else {
            h: float(s) * self.weight for h, s in (result or {}).items()
        }

    def bind(self, pod: Pod, node_name: str) -> None:
        result = self._call(
            "bind",
            {"podNamespace": pod.namespace, "podName": pod.name,
             "podUID": pod.uid, "node": node_name},
        )
        if result and result.get("error"):
            raise ExtenderError(result["error"])

    def process_preemption(
        self, pod: Pod, victims_by_node: Dict[str, List[Pod]]
    ) -> Dict[str, List[Pod]]:
        if not self.supports_preemption():
            return victims_by_node
        payload = {
            "pod": _pod_to_dict(pod),
            "nodeNameToVictims": {
                n: [_pod_to_dict(v) for v in vs]
                for n, vs in victims_by_node.items()
            },
        }
        result = self._call("process_preemption", payload)
        if result is None:
            return victims_by_node
        keep = set(result.get("nodeNames", victims_by_node.keys()))
        return {n: vs for n, vs in victims_by_node.items() if n in keep}


def _pod_to_dict(pod: Pod) -> dict:
    return {
        "metadata": {
            "name": pod.name,
            "namespace": pod.namespace,
            "uid": pod.uid,
            "labels": dict(pod.metadata.labels),
        }
    }
