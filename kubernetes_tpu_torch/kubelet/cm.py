"""Container manager: QoS classes + cgroup-tree accounting (reference
``pkg/kubelet/cm/container_manager_linux.go:210 NewContainerManager`` +
``cm/qos_container_manager_linux.go`` + ``cm/pod_container_manager_
linux.go``; QoS classification ``pkg/apis/core/v1/helper/qos/qos.go``).

The reference programs real cgroupfs; this build maintains the SAME
tree as in-process state — /kubepods with burstable/besteffort QoS
tiers, one pod cgroup per pod parented by QoS class, cpu shares/quota
and memory limits derived from requests/limits with the reference's
formulas (MilliCPUToShares: shares = max(2, milli*1024/1000);
MilliCPUToQuota: quota = milli*100000/1000) — so node-level resource
enforcement, the eviction manager's accounting, and operator
introspection see the hierarchy the reference kernel would.

Node allocatable (``cm/node_container_manager_linux.go``):
allocatable = capacity − kube-reserved − system-reserved; enforced by
admission (``_admit``) exactly like the reference's node allocatable
enforcement rejects pods past the kubepods cgroup limit.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Optional

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.scheduler.types import compute_pod_resource_request

GUARANTEED = "Guaranteed"
BURSTABLE = "Burstable"
BEST_EFFORT = "BestEffort"

MIN_SHARES = 2
SHARES_PER_CPU = 1024
QUOTA_PERIOD = 100_000


def pod_qos(pod: Pod) -> str:
    """qos.go GetPodQOS: Guaranteed iff every container has cpu+memory
    limits equal to its requests; BestEffort iff no container has any
    request or limit; else Burstable."""
    requests_seen = False
    limits_seen = False
    guaranteed = True
    for c in pod.spec.containers + pod.spec.init_containers:
        req = c.resources.requests
        lim = c.resources.limits
        for res in ("cpu", "memory"):
            r, l = req.get(res), lim.get(res)
            if r is not None:
                requests_seen = True
            if l is not None:
                limits_seen = True
            # milli-precision compare ("500m" vs "1" must differ;
            # Quantity.value() rounds sub-unit cpu up)
            if l is None or r is None or \
                    r.milli_value() != l.milli_value():
                guaranteed = False
    if not requests_seen and not limits_seen:
        return BEST_EFFORT
    if guaranteed:
        return GUARANTEED
    return BURSTABLE


def milli_cpu_to_shares(milli: int) -> int:
    """cm/helpers_linux.go MilliCPUToShares."""
    if milli <= 0:
        return MIN_SHARES
    return max(MIN_SHARES, milli * SHARES_PER_CPU // 1000)


def milli_cpu_to_quota(milli: int) -> int:
    """cm/helpers_linux.go MilliCPUToQuota (period 100ms); 0 = no
    quota (unlimited)."""
    if milli <= 0:
        return 0
    return milli * QUOTA_PERIOD // 1000


@dataclass
class CgroupConfig:
    """One node in the tree (cm/types.go CgroupConfig)."""

    name: str
    parent: str = ""
    cpu_shares: int = MIN_SHARES
    cpu_quota: int = 0      # 0 = unlimited
    memory_limit: int = 0   # 0 = unlimited
    pods: Dict[str, str] = field(default_factory=dict)  # uid -> qos


class ContainerManager:
    """The in-process cgroup hierarchy + QoS manager."""

    ROOT = "/kubepods"

    def __init__(self, capacity_cpu_milli: int = 0,
                 capacity_memory: int = 0,
                 kube_reserved_cpu_milli: int = 0,
                 kube_reserved_memory: int = 0,
                 system_reserved_cpu_milli: int = 0,
                 system_reserved_memory: int = 0):
        self._lock = threading.Lock()
        self.capacity_cpu = capacity_cpu_milli
        self.capacity_memory = capacity_memory
        self.allocatable_cpu = max(
            0, capacity_cpu_milli - kube_reserved_cpu_milli
            - system_reserved_cpu_milli,
        )
        self.allocatable_memory = max(
            0, capacity_memory - kube_reserved_memory
            - system_reserved_memory,
        )
        self.cgroups: Dict[str, CgroupConfig] = {}
        # the qos tiers (qosContainerManager Start): Guaranteed pods sit
        # directly under /kubepods; burstable/besteffort get sub-tiers
        self._ensure(self.ROOT, "", cpu_shares=milli_cpu_to_shares(
            self.allocatable_cpu), memory_limit=self.allocatable_memory)
        self._ensure(f"{self.ROOT}/burstable", self.ROOT)
        self._ensure(f"{self.ROOT}/besteffort", self.ROOT,
                     cpu_shares=MIN_SHARES)
        self._pod_cgroup: Dict[str, str] = {}   # uid -> cgroup path
        self._pod_usage: Dict[str, tuple] = {}  # uid -> (cpu, mem)

    def _ensure(self, name: str, parent: str, cpu_shares: int = MIN_SHARES,
                cpu_quota: int = 0, memory_limit: int = 0) -> CgroupConfig:
        cg = self.cgroups.get(name)
        if cg is None:
            cg = CgroupConfig(name=name, parent=parent,
                              cpu_shares=cpu_shares, cpu_quota=cpu_quota,
                              memory_limit=memory_limit)
            self.cgroups[name] = cg
        return cg

    # -- admission (node allocatable enforcement) ----------------------
    def admit(self, pod: Pod) -> Optional[str]:
        """None = admitted; else the rejection reason. The reference
        enforces node allocatable via the /kubepods cgroup limits; here
        the running pods' requests are summed against allocatable."""
        req = compute_pod_resource_request(pod)
        with self._lock:
            used_cpu = sum(u[0] for u in self._pod_usage.values())
            used_mem = sum(u[1] for u in self._pod_usage.values())
            if self.allocatable_cpu and \
                    used_cpu + req.milli_cpu > self.allocatable_cpu:
                return (
                    f"OutOfcpu: {used_cpu}+{req.milli_cpu}m over "
                    f"allocatable {self.allocatable_cpu}m"
                )
            if self.allocatable_memory and \
                    used_mem + req.memory > self.allocatable_memory:
                return (
                    f"OutOfmemory: {used_mem}+{req.memory} over "
                    f"allocatable {self.allocatable_memory}"
                )
        return None

    # -- pod cgroup lifecycle (podContainerManager) --------------------
    def create_pod_cgroup(self, pod: Pod) -> str:
        qos = pod_qos(pod)
        req = compute_pod_resource_request(pod)
        limits_cpu = 0
        limits_mem = 0
        for c in pod.spec.containers:
            lc = c.resources.limits.get("cpu")
            lm = c.resources.limits.get("memory")
            if lc is not None:
                limits_cpu += int(lc.milli_value())
            if lm is not None:
                limits_mem += int(lm.value())
        parent = {
            GUARANTEED: self.ROOT,
            BURSTABLE: f"{self.ROOT}/burstable",
            BEST_EFFORT: f"{self.ROOT}/besteffort",
        }[qos]
        path = f"{parent}/pod{pod.uid}"
        with self._lock:
            self._ensure(
                path, parent,
                cpu_shares=milli_cpu_to_shares(req.milli_cpu),
                cpu_quota=milli_cpu_to_quota(limits_cpu),
                memory_limit=limits_mem,
            )
            self.cgroups[parent].pods[pod.uid] = qos
            self._pod_cgroup[pod.uid] = path
            self._pod_usage[pod.uid] = (req.milli_cpu, req.memory)
            self._update_qos_tiers_locked()
        return path

    def delete_pod_cgroup(self, uid: str) -> None:
        with self._lock:
            path = self._pod_cgroup.pop(uid, None)
            self._pod_usage.pop(uid, None)
            if path is None:
                return
            cg = self.cgroups.pop(path, None)
            if cg is not None:
                parent = self.cgroups.get(cg.parent)
                if parent is not None:
                    parent.pods.pop(uid, None)
            self._update_qos_tiers_locked()

    def _update_qos_tiers_locked(self) -> None:
        """qos_container_manager_linux.go setCPUCgroupConfig: the
        burstable tier's shares track the sum of its pods' cpu
        requests; besteffort stays at the 2-share floor."""
        burst = self.cgroups[f"{self.ROOT}/burstable"]
        total = 0
        for uid in burst.pods:
            total += self._pod_usage.get(uid, (0, 0))[0]
        burst.cpu_shares = milli_cpu_to_shares(total)

    # -- introspection --------------------------------------------------
    def qos_of(self, uid: str) -> Optional[str]:
        with self._lock:
            path = self._pod_cgroup.get(uid)
            if path is None:
                return None
            cg = self.cgroups.get(path)
            parent = self.cgroups.get(cg.parent) if cg else None
            return parent.pods.get(uid) if parent else None

    def pod_cgroup(self, uid: str) -> Optional[CgroupConfig]:
        with self._lock:
            path = self._pod_cgroup.get(uid)
            return self.cgroups.get(path) if path else None

    def tree(self) -> Dict[str, CgroupConfig]:
        with self._lock:
            return dict(self.cgroups)
