"""Admission control chain for the REST path.

Behavioral equivalent of the reference's admission stage in the apiserver
handler chain (``staging/src/k8s.io/apiserver/pkg/admission``): after
authn/authz and before the registry write, every mutating request passes
through an ordered chain of admission plugins, each of which may mutate
the object (``MutationInterface``) and/or reject it
(``ValidationInterface``). Built-ins here mirror the upstream plugins the
scheduling path actually feels:

- ``NamespaceLifecycle`` — reject creates in terminating/absent namespaces
  (``plugin/pkg/admission/namespace/lifecycle``)
- ``DefaultTolerationSeconds`` — add default 300s tolerations for the
  not-ready/unreachable NoExecute taints to every pod
  (``plugin/pkg/admission/defaulttolerationseconds``)
- ``LimitRanger``-style request defaulting — containers with no cpu/mem
  request get namespace defaults so the scheduler's fit math sees nonzero
  vectors (``plugin/pkg/admission/limitranger``)
- ``TaintNodesByCondition``-adjacent ``PodPriority`` resolution — map
  priorityClassName → numeric priority (``plugin/pkg/admission/priority``)
- ``ServiceAccountAdmission``, ``NodeRestriction``,
  ``DefaultStorageClass`` and ``ResourceQuotaAdmission``, which the
  apiserver appends to the chain with its store.

The JAX package's AlwaysPullImages, EventRateLimit, PodNodeSelector and
webhook plugins are not ported: no chain of the port uses them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from kubernetes_tpu_torch.api.resource import parse_quantity
from kubernetes_tpu_torch.api.types import Pod, Toleration

CREATE, UPDATE, DELETE = "CREATE", "UPDATE", "DELETE"


class AdmissionError(Exception):
    """Request rejected by an admission plugin (HTTP 403/422 at the REST
    layer)."""


@dataclass
class AdmissionRequest:
    operation: str
    kind: str
    namespace: str
    obj: Any
    old_obj: Any = None
    user: str = "system:anonymous"
    # "status" for pods/status writes
    subresource: str = ""


class AdmissionPlugin:
    name = "plugin"

    def admit(self, req: AdmissionRequest) -> None:
        """Mutating pass — may modify req.obj in place."""

    def validate(self, req: AdmissionRequest) -> None:
        """Validating pass — raise AdmissionError to reject."""


class NamespaceLifecycle(AdmissionPlugin):
    name = "NamespaceLifecycle"

    def __init__(self, namespaces: Optional[Dict[str, str]] = None,
                 store=None):
        # namespace -> phase ("Active"/"Terminating"); or a live store
        # (Namespace objects consulted per request). With neither, the
        # world is open. Deviation from upstream: a namespace with no
        # Namespace OBJECT stays open (the perf harness schedules into
        # "default" without creating namespace objects); only an
        # explicitly Terminating namespace rejects creates.
        self.namespaces = namespaces
        self.store = store

    def _phase(self, namespace: str) -> Optional[str]:
        if self.namespaces is not None:
            return self.namespaces.get(namespace)
        if self.store is not None:
            ns = self.store.get_namespace(namespace)
            return ns.phase if ns is not None else "__absent__"
        return None

    def validate(self, req: AdmissionRequest) -> None:
        if req.operation != CREATE or req.kind == "Namespace":
            return
        if self.namespaces is None and self.store is None:
            return
        phase = self._phase(req.namespace)
        if phase is None and self.namespaces is not None:
            raise AdmissionError(f"namespace {req.namespace!r} not found")
        if phase == "Terminating":
            raise AdmissionError(
                f"namespace {req.namespace!r} is terminating; "
                "no new objects may be created"
            )


class DefaultTolerationSeconds(AdmissionPlugin):
    name = "DefaultTolerationSeconds"

    NOT_READY = "node.kubernetes.io/not-ready"
    UNREACHABLE = "node.kubernetes.io/unreachable"

    def __init__(self, seconds: int = 300):
        self.seconds = seconds

    def admit(self, req: AdmissionRequest) -> None:
        if req.kind != "Pod" or req.operation != CREATE:
            return
        pod: Pod = req.obj
        tols = pod.spec.tolerations
        have = {
            t.key
            for t in tols
            if t.effect in ("NoExecute", "") and t.key in (self.NOT_READY, self.UNREACHABLE)
        }
        for key in (self.NOT_READY, self.UNREACHABLE):
            if key not in have:
                tols.append(
                    Toleration(
                        key=key,
                        operator="Exists",
                        effect="NoExecute",
                        toleration_seconds=self.seconds,
                    )
                )


class LimitRanger(AdmissionPlugin):
    name = "LimitRanger"

    def __init__(self, default_requests: Optional[Dict[str, str]] = None):
        self.defaults = {
            k: parse_quantity(v)
            for k, v in (default_requests or {}).items()
        }

    def admit(self, req: AdmissionRequest) -> None:
        if req.kind != "Pod" or req.operation != CREATE or not self.defaults:
            return
        pod: Pod = req.obj
        for c in pod.spec.containers:
            for res, qty in self.defaults.items():
                if res not in c.resources.requests:
                    c.resources.requests[res] = qty


# reference pkg/apis/scheduling/types.go built-ins
SYSTEM_PRIORITY_CLASSES = {
    "system-cluster-critical": 2000000000,
    "system-node-critical": 2000001000,
}


class PodPriorityResolver(AdmissionPlugin):
    """Priority admission (reference ``plugin/pkg/admission/priority/
    admission.go``): resolve ``priorityClassName`` → numeric priority
    from PriorityClass API objects (plus the two system built-ins); a
    pod naming no class gets the cluster's globalDefault class when one
    exists. A static dict may seed/override resolution (the harness's
    offline mode)."""

    name = "Priority"

    def __init__(self, priority_classes: Optional[Dict[str, int]] = None,
                 store=None):
        self.classes = dict(priority_classes or {})
        self.store = store

    def _resolve(self, name: str) -> Optional[int]:
        got = self.classes.get(name)
        if got is not None:
            return got
        got = SYSTEM_PRIORITY_CLASSES.get(name)
        if got is not None:
            return got
        if self.store is not None:
            pc = self.store.get_object("PriorityClass", "", name)
            if pc is not None:
                return pc.value
        return None

    def admit(self, req: AdmissionRequest) -> None:
        if req.kind != "Pod" or req.operation != CREATE:
            return
        pod: Pod = req.obj
        cls = getattr(pod.spec, "priority_class_name", "")
        if cls:
            value = self._resolve(cls)
            if value is None:
                raise AdmissionError(f"no PriorityClass {cls!r}")
            pod.spec.priority = value
        elif pod.spec.priority is None and self.store is not None:
            defaults = [
                pc for pc in self.store.list_priority_classes()
                if pc.global_default
            ]
            if defaults:
                # upstream picks the LOWEST value among multiple
                # globalDefault classes (admission.go: "we pick the one
                # with the lowest priority value") — not the newest
                chosen = min(defaults, key=lambda pc: pc.value)
                pod.spec.priority_class_name = chosen.name
                pod.spec.priority = chosen.value

    def validate(self, req: AdmissionRequest) -> None:
        pass


class ResourceQuotaAdmission(AdmissionPlugin):
    """Quota gatekeeping (``plugin/pkg/admission/resourcequota``): a pod
    CREATE that would push any quota dimension in its namespace past
    ``hard`` is rejected. Usage is charged SYNCHRONOUSLY here, like the
    upstream plugin's transactional quota evaluator: live usage is
    recomputed from the store's pods plus the in-flight charges this
    plugin has admitted but the registry hasn't persisted yet — the
    controller's async ``status.used`` is reporting, not enforcement
    (a burst of creates would race a status-based check)."""

    name = "ResourceQuota"

    PENDING_TTL = 30.0  # in-flight charge expiry (failed create path)

    def __init__(self, store=None):
        import threading

        self.store = store
        self._lock = threading.Lock()
        # (ns, name) -> (charge time, cpu_milli, mem) admitted but not
        # yet visible in the store
        self._pending: Dict[tuple, tuple] = {}

    def validate(self, req: AdmissionRequest) -> None:
        if self.store is None or req.kind != "Pod" or \
                req.operation != CREATE:
            return
        quotas = [
            q for q in self.store.list_resource_quotas()
            if q.namespace == req.namespace
        ]
        if not quotas:
            return
        import time as _time

        pod: Pod = req.obj
        cpu_milli = sum(
            int(c.resources.requests["cpu"].milli_value())
            for c in pod.spec.containers if "cpu" in c.resources.requests
        )
        mem = sum(
            int(c.resources.requests["memory"].value())
            for c in pod.spec.containers
            if "memory" in c.resources.requests
        )
        deltas = {
            "pods": 1,
            "requests.cpu": cpu_milli,
            "cpu": cpu_milli,
            "requests.memory": mem,
            "memory": mem,
        }
        with self._lock:
            now = _time.time()
            # namespace filter runs store-side (one pass under the store
            # lock) — a cluster-wide copy per quota'd CREATE would make
            # admission O(all pods) under this plugin-global lock
            live = [
                p for p in self.store.list_pods(namespace=req.namespace)
                if p.status.phase not in ("Succeeded", "Failed")
            ]
            # settle in-flight charges: visible in the store now
            # (checked against the entry's OWN namespace — an entry
            # from another namespace must not linger to TTL), or
            # expired (the create failed without a rollback call)
            self._pending = {
                k: v for k, v in self._pending.items()
                if now - v[0] < self.PENDING_TTL
                and self.store.get_pod(k[0], k[1]) is None
            }
            pend = [v for k, v in self._pending.items()
                    if k[0] == req.namespace]
            used_cpu = sum(
                int(c.resources.requests["cpu"].milli_value())
                for p in live for c in p.spec.containers
                if "cpu" in c.resources.requests
            ) + sum(v[1] for v in pend)
            used_mem = sum(
                int(c.resources.requests["memory"].value())
                for p in live for c in p.spec.containers
                if "memory" in c.resources.requests
            ) + sum(v[2] for v in pend)
            usage = {
                "pods": len(live) + len(pend),
                "requests.cpu": used_cpu, "cpu": used_cpu,
                "requests.memory": used_mem, "memory": used_mem,
            }
            for quota in quotas:
                for key, hard in quota.hard.items():
                    delta = deltas.get(key)
                    if delta is None:
                        continue
                    hard_v = (
                        int(hard.milli_value())
                        if key in ("requests.cpu", "cpu")
                        else int(hard.value())
                    )
                    if usage[key] + delta > hard_v:
                        raise AdmissionError(
                            f"exceeded quota {quota.name}: {key} "
                            f"(used {usage[key]} + requested {delta} > "
                            f"hard {hard_v})"
                        )
            # admitted: charge before releasing the lock
            self._pending[(req.namespace, pod.name)] = (
                now, cpu_milli, mem,
            )

    def rollback(self, req: AdmissionRequest) -> None:
        """Drop the in-flight charge immediately when the create fails
        downstream (later plugin rejection, store conflict) — without
        this the phantom charge blocks namespace headroom for up to
        PENDING_TTL seconds, spuriously rejecting creates that fit."""
        if req.kind != "Pod" or req.operation != CREATE:
            return
        with self._lock:
            self._pending.pop((req.namespace, req.obj.metadata.name), None)


class ServiceAccountAdmission(AdmissionPlugin):
    """ServiceAccount admission (reference ``plugin/pkg/admission/
    serviceaccount/admission.go:100 Admit``): pods that name no service
    account get the namespace's ``default`` account injected; a pod
    naming a NONEXISTENT account is rejected. Deviation from upstream
    (documented like NamespaceLifecycle's): the injected ``default`` is
    allowed to be absent — the serviceaccount controller provisions it
    asynchronously per namespace, and the perf harness schedules into
    namespaces that have no objects at all; only an EXPLICITLY named
    missing account rejects."""

    name = "ServiceAccount"

    DEFAULT = "default"

    def __init__(self, store=None):
        self.store = store

    def admit(self, req: AdmissionRequest) -> None:
        if req.kind != "Pod" or req.operation != CREATE:
            return
        pod: Pod = req.obj
        if not pod.spec.service_account_name:
            pod.spec.service_account_name = self.DEFAULT

    def validate(self, req: AdmissionRequest) -> None:
        if self.store is None or req.kind != "Pod" or \
                req.operation != CREATE:
            return
        pod: Pod = req.obj
        sa = pod.spec.service_account_name
        if sa and sa != self.DEFAULT and \
                self.store.get_service_account(req.namespace, sa) is None:
            raise AdmissionError(
                f"service account {req.namespace}/{sa} not found"
            )


IS_DEFAULT_CLASS_ANNOTATION = "storageclass.kubernetes.io/is-default-class"


class DefaultStorageClass(AdmissionPlugin):
    """Assign the cluster's default StorageClass to claims that name
    none (reference ``plugin/pkg/admission/storage/storageclass/
    setdefault/admission.go`` — default-enabled upstream): a PVC
    created with no class gets the class annotated
    ``storageclass.kubernetes.io/is-default-class``; with several
    marked default, the NEWEST wins (the reference's current
    tie-break)."""

    name = "DefaultStorageClass"

    def __init__(self, store=None):
        self.store = store

    def admit(self, req: AdmissionRequest) -> None:
        if self.store is None or req.kind != "PersistentVolumeClaim" \
                or req.operation != CREATE:
            return
        pvc = req.obj
        # only a NIL class is defaulted — an explicit "" is the user
        # asking for classless static provisioning (upstream semantics)
        if pvc.storage_class_name is not None:
            return
        defaults = [
            sc for sc in self.store.list_storage_classes()
            if sc.metadata.annotations.get(
                IS_DEFAULT_CLASS_ANNOTATION) == "true"
        ]
        if not defaults:
            return
        newest = max(defaults,
                     key=lambda sc: sc.metadata.creation_timestamp)
        pvc.storage_class_name = newest.name




MIRROR_POD_ANNOTATION = "kubernetes.io/config.mirror"


class NodeRestriction(AdmissionPlugin):
    """Node identity confinement (reference ``plugin/pkg/admission/
    noderestriction/admission.go:79 Admit``): a kubelet authenticating
    as ``system:node:<name>`` may only touch its OWN Node object and
    pods BOUND to it — node A's credentials patching node B (or B's
    pods) is exactly the lateral movement this plugin exists to stop.
    Creates of regular pods by node identities are rejected; mirror
    pods (``kubernetes.io/config.mirror`` annotation) are allowed only
    on the node itself."""

    name = "NodeRestriction"

    PREFIX = "system:node:"

    def validate(self, req: AdmissionRequest) -> None:
        user = req.user or ""
        if not user.startswith(self.PREFIX):
            return
        node_name = user[len(self.PREFIX):]
        if req.kind == "Node":
            target = (req.obj or req.old_obj).metadata.name
            if target != node_name:
                raise AdmissionError(
                    f"node {node_name!r} is not allowed to modify node "
                    f"{target!r}"
                )
        elif req.kind == "Pod":
            if req.operation == CREATE:
                pod: Pod = req.obj
                if MIRROR_POD_ANNOTATION not in pod.metadata.annotations:
                    raise AdmissionError(
                        f"node {node_name!r} may only create mirror pods"
                    )
                if pod.spec.node_name != node_name:
                    raise AdmissionError(
                        f"node {node_name!r} may only create mirror pods "
                        f"bound to itself"
                    )
                return
            bound = (req.old_obj or req.obj).spec.node_name
            if bound != node_name:
                raise AdmissionError(
                    f"node {node_name!r} is not allowed to modify pods "
                    f"bound to node {bound!r}"
                )


@dataclass
class AdmissionChain:
    """Ordered plugin chain: all mutating passes, then all validating
    passes (reference admission.NewChainHandler ordering)."""

    plugins: List[AdmissionPlugin] = field(default_factory=list)

    @classmethod
    def default(cls) -> "AdmissionChain":
        return cls(
            [
                NamespaceLifecycle(),
                DefaultTolerationSeconds(),
                LimitRanger(),
                PodPriorityResolver(),
            ]
        )

    def run(self, req: AdmissionRequest) -> Any:
        ran: List[AdmissionPlugin] = []
        try:
            for p in self.plugins:
                p.admit(req)
                ran.append(p)
            for p in self.plugins:
                p.validate(req)
                if p not in ran:
                    ran.append(p)
        except Exception:
            # a later plugin rejected after earlier ones took side
            # effects (e.g. the quota plugin's in-flight charge):
            # unwind them NOW instead of letting a 30s TTL hold the
            # headroom hostage (upstream's quota evaluator is
            # transactional for the same reason)
            self.rollback(req, ran)
            raise
        return req.obj

    def validate_only(self, req: AdmissionRequest) -> None:
        """Run just the validating passes — the DELETE path's admission
        (the reference dispatches DELETE through validating admission;
        there is no object body to mutate)."""
        for p in self.plugins:
            p.validate(req)

    def rollback(self, req: AdmissionRequest,
                 plugins: Optional[List[AdmissionPlugin]] = None) -> None:
        """Undo admission side effects after a downstream failure (a
        later plugin's rejection, a store conflict, an allocator
        error). Safe to call for requests with no side effects."""
        for p in (plugins if plugins is not None else self.plugins):
            hook = getattr(p, "rollback", None)
            if hook is not None:
                try:
                    hook(req)
                except Exception:  # noqa: BLE001 — unwind must not mask
                    pass
