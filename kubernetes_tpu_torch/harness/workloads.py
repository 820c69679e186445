"""Benchmark workloads as op lists (the scheduler_perf op DSL):
``{"opcode": "createNodes" | "createPods" | "barrier" | "setup", ...}``,
at any node and pod count. A ``createPods`` op with
``skipWaitToCompletion`` does not wait for its pods to be bound; a
``setup`` op calls its ``fn`` with the store (the storage objects of the
volume rows)."""

from __future__ import annotations

from typing import Dict, List

from kubernetes_tpu_torch.api.resource import parse_quantity
from kubernetes_tpu_torch.api.types import (
    CSINode,
    CSINodeDriver,
    ObjectMeta,
    PersistentVolume,
    PersistentVolumeClaim,
    StorageClass,
)


def _zone(i: int, zones: int = 10) -> str:
    return f"zone-{i % zones}"


def node_template(i: int, cpu: str = "32", memory: str = "64Gi",
                  zones: int = 10) -> dict:
    return {
        "metadata": {
            "name": f"node-{i}",
            "labels": {
                "kubernetes.io/hostname": f"node-{i}",
                "topology.kubernetes.io/zone": _zone(i, zones),
            },
        },
        "status": {
            "capacity": {"cpu": cpu, "memory": memory, "pods": "110"},
        },
    }


def basic_pod(i: int, cpu: str = "500m", memory: str = "500Mi",
              labels: Dict[str, str] = None, extra_spec: dict = None) -> dict:
    spec = {
        "containers": [
            {"name": "c", "image": "registry/fake:1",
             "resources": {"requests": {"cpu": cpu, "memory": memory}}}
        ],
    }
    if extra_spec:
        spec.update(extra_spec)
    return {
        "metadata": {"name": f"pod-{i}", "labels": dict(labels or {})},
        "spec": spec,
    }


def _spread(max_skew: int, key: str, action: str,
            labels: Dict[str, str]) -> dict:
    return {
        "topologySpreadConstraints": [
            {"maxSkew": max_skew, "topologyKey": key,
             "whenUnsatisfiable": action,
             "labelSelector": {"matchLabels": labels}}
        ]
    }


def _affinity(kind: str, key: str, values: List[str], topo: str,
              weight: int = 0) -> dict:
    """A ``podAffinity`` or ``podAntiAffinity`` block (``kind``) with one
    term matching ``key`` In ``values`` over ``topo``: required, or
    preferred with ``weight``."""
    term = {
        "labelSelector": {"matchExpressions": [
            {"key": key, "operator": "In", "values": values}]},
        "topologyKey": topo,
    }
    if weight:
        block = {"preferredDuringSchedulingIgnoredDuringExecution": [
            {"weight": weight, "podAffinityTerm": term}]}
    else:
        block = {"requiredDuringSchedulingIgnoredDuringExecution": [term]}
    return {"affinity": {kind: block}}


def _pods_op(count: int, pod_fn, collect: bool = False,
             offset: int = 0, skip_wait: bool = False) -> dict:
    return {"opcode": "createPods", "count": count, "podTemplate": pod_fn,
            "collectMetrics": collect, "offset": offset,
            "skipWaitToCompletion": skip_wait}


def _nodes_op(count: int, cpu: str = "32", memory: str = "64Gi") -> dict:
    return {"opcode": "createNodes", "count": count,
            "nodeTemplate": lambda i: node_template(i, cpu=cpu,
                                                    memory=memory)}


def _barrier() -> dict:
    return {"opcode": "barrier"}


def scheduling_basic(nodes: int, init_pods: int, measure_pods: int
                     ) -> List[dict]:
    return [
        _nodes_op(nodes),
        _pods_op(init_pods, lambda i: basic_pod(i)),
        _barrier(),
        _pods_op(measure_pods, lambda i: basic_pod(i), collect=True,
                 offset=init_pods),
    ]


def scheduling_pod_anti_affinity(nodes: int, init_pods: int,
                                 measure_pods: int) -> List[dict]:
    """Measured pods in 100 colours, each with a required hostname
    anti-affinity to its own colour: no node holds two pods of one
    colour."""
    def pod(i):
        p = basic_pod(i, labels={"color": f"blue-{i % 100}"})
        p["spec"].update(_affinity("podAntiAffinity", "color",
                                   [f"blue-{i % 100}"],
                                   "kubernetes.io/hostname"))
        return p

    return [
        _nodes_op(nodes),
        _pods_op(init_pods, lambda i: basic_pod(i)),
        _barrier(),
        _pods_op(measure_pods, pod, collect=True, offset=init_pods),
    ]


def scheduling_pod_affinity(nodes: int, init_pods: int, measure_pods: int
                            ) -> List[dict]:
    """Pods in 50 groups (the init pods too); each measured pod requires
    affinity to its own group over zones (T = 50 tracked terms)."""
    def pod(i):
        p = basic_pod(i, labels={"group": f"g{i % 50}"})
        p["spec"].update(_affinity("podAffinity", "group", [f"g{i % 50}"],
                                   "topology.kubernetes.io/zone"))
        return p

    return [
        _nodes_op(nodes),
        _pods_op(init_pods,
                 lambda i: basic_pod(i, labels={"group": f"g{i % 50}"})),
        _barrier(),
        _pods_op(measure_pods, pod, collect=True, offset=init_pods),
    ]


def scheduling_preferred_pod_affinity(nodes: int, init_pods: int,
                                      measure_pods: int) -> List[dict]:
    """Pods in 50 groups; each measured pod prefers (weight 10) a node
    holding its own group (T = 50)."""
    def pod(i):
        p = basic_pod(i, labels={"group": f"g{i % 50}"})
        p["spec"].update(_affinity("podAffinity", "group", [f"g{i % 50}"],
                                   "kubernetes.io/hostname", weight=10))
        return p

    return [
        _nodes_op(nodes),
        _pods_op(init_pods,
                 lambda i: basic_pod(i, labels={"group": f"g{i % 50}"})),
        _barrier(),
        _pods_op(measure_pods, pod, collect=True, offset=init_pods),
    ]


def scheduling_preferred_anti_affinity(nodes: int, init_pods: int,
                                       measure_pods: int) -> List[dict]:
    """Pods in 100 colours; each measured pod prefers (weight 10, a
    negative preferred weight) a node without its own colour (T = 100)."""
    def pod(i):
        p = basic_pod(i, labels={"color": f"c{i % 100}"})
        p["spec"].update(_affinity("podAntiAffinity", "color",
                                   [f"c{i % 100}"], "kubernetes.io/hostname",
                                   weight=10))
        return p

    return [
        _nodes_op(nodes),
        _pods_op(init_pods,
                 lambda i: basic_pod(i, labels={"color": f"c{i % 100}"})),
        _barrier(),
        _pods_op(measure_pods, pod, collect=True, offset=init_pods),
    ]


def gang_scheduling(nodes: int, init_pods: int, measure_pods: int,
                    gang_size: int = 10) -> List[dict]:
    """Measured pods in coscheduling gangs of ``gang_size`` (each binds
    whole or not at all), spread over zones with a hard skew of 5."""
    def pod(i):
        p = basic_pod(i, labels={
            "app": "gang",
            "pod-group.scheduling.k8s.io/name": f"gang-{i // gang_size}",
            "pod-group.scheduling.k8s.io/min-available": str(gang_size),
        })
        p["spec"].update(_spread(5, "topology.kubernetes.io/zone",
                                 "DoNotSchedule", {"app": "gang"}))
        return p

    return [
        _nodes_op(nodes),
        _pods_op(init_pods, lambda i: basic_pod(i)),
        _barrier(),
        _pods_op(measure_pods, pod, collect=True, offset=init_pods),
    ]


def spread_pod(i: int) -> dict:
    """A pod spread over zones, at most one pod of skew (DoNotSchedule)."""
    p = basic_pod(i, labels={"app": "spread"})
    p["spec"].update(_spread(1, "topology.kubernetes.io/zone",
                             "DoNotSchedule", {"app": "spread"}))
    return p


def topology_spreading(nodes: int, init_pods: int, measure_pods: int
                       ) -> List[dict]:
    return [
        _nodes_op(nodes),
        _pods_op(init_pods, lambda i: basic_pod(i)),
        _barrier(),
        _pods_op(measure_pods, spread_pod, collect=True, offset=init_pods),
    ]


def churn(nodes: int, waves: int, per_wave: int, delete_fraction: float = 0.10,
          update_fraction: float = 0.02, seed: int = 0,
          pending_delete_after: int = 3) -> List[dict]:
    """SchedulingBasic nodes and pods in ``waves`` waves of ``per_wave``;
    after each wave a seeded ``delete_fraction`` of the bound pods is
    deleted in bulk and a seeded ``update_fraction`` of the nodes gets a
    new allocatable cpu. The wave after wave ``pending_delete_after``
    (counting from 1) also deletes one bound pod while its first solved
    batch waits for its commit. Every wave is measured."""
    ops = [_nodes_op(nodes)]
    for w in range(waves):
        op = _pods_op(per_wave, lambda i: basic_pod(i), collect=True,
                      offset=w * per_wave)
        if w == pending_delete_after:
            op["deleteWhilePending"] = seed * 1000 + w
        ops += [op,
                {"opcode": "deletePods", "fraction": delete_fraction,
                 "seed": seed * 1000 + 2 * w},
                {"opcode": "updateNodes", "fraction": update_fraction,
                 "seed": seed * 1000 + 2 * w + 1}]
    return ops


def _prio(pod: dict, priority: int) -> dict:
    pod["spec"]["priority"] = priority
    return pod


def preemption(nodes: int, init_pods: int, measure_pods: int
               ) -> List[dict]:
    """Nodes of 4 cpu filled by priority-1 pods of 3 cpu, one a node when
    ``init_pods == nodes``; then priority-100 pods of 3 cpu, each of which
    must preempt one."""
    return [
        _nodes_op(nodes, cpu="4", memory="8Gi"),
        _pods_op(init_pods, lambda i: _prio(basic_pod(i, cpu="3"), 1)),
        _barrier(),
        _pods_op(measure_pods, lambda i: _prio(basic_pod(i, cpu="3"), 100),
                 collect=True, offset=init_pods),
    ]


def unschedulable(nodes: int, init_pods: int, measure_pods: int
                  ) -> List[dict]:
    """``init_pods`` pods whose node selector no node matches stay pending
    (their op does not wait) while the measured pods schedule."""
    def impossible(i):
        p = basic_pod(i)
        p["spec"]["nodeSelector"] = {"no-such-label": "true"}
        return p

    return [
        _nodes_op(nodes),
        _pods_op(init_pods, impossible, skip_wait=True),
        _pods_op(measure_pods, lambda i: basic_pod(i), collect=True,
                 offset=init_pods),
    ]


def _pvc_pod(i: int, claim: str, cpu: str = "500m") -> dict:
    p = basic_pod(i, cpu=cpu)
    p["spec"]["volumes"] = [
        {"name": "data", "persistentVolumeClaim": {"claimName": claim}}]
    return p


def _volumes_setup(count: int, storage_class: str, binding_mode: str,
                   provisioner: str = "kubernetes.io/fake",
                   csi_driver: str = "", prebound: bool = True,
                   offset: int = 0) -> dict:
    """A StorageClass and one PV and claim a pod (``claim-i``, ``pv-i``
    for i from ``offset``), bound to each other unless not ``prebound``
    (then the PVs are Available and the claims Pending). ``csi_driver``
    marks the PVs as served by that CSI driver, so they count against its
    CSINode attach limits."""
    def setup(store):
        store.add_storage_class(StorageClass(
            metadata=ObjectMeta(name=storage_class), provisioner=provisioner,
            volume_binding_mode=binding_mode))
        for i in range(offset, offset + count):
            claim = f"claim-{i}"
            store.add_pv(PersistentVolume(
                metadata=ObjectMeta(name=f"pv-{i}"),
                capacity={"storage": parse_quantity("1Gi")},
                storage_class_name=storage_class,
                claim_ref=f"default/{claim}" if prebound else None,
                phase="Bound" if prebound else "Available",
                csi_driver=csi_driver))
            store.add_pvc(PersistentVolumeClaim(
                metadata=ObjectMeta(name=claim, namespace="default"),
                storage_class_name=storage_class,
                requests={"storage": parse_quantity("1Gi")},
                volume_name=f"pv-{i}" if prebound else "",
                phase="Bound" if prebound else "Pending"))
    return {"opcode": "setup", "fn": setup}


def _pv_workload(storage_class: str, provisioner: str, csi_driver: str = "",
                 extra_setup=None):
    """The rows of bound PV claims: each measured pod has a claim of its
    own, bound to its own PV; ``extra_setup(nodes)`` adds more storage
    objects."""
    def build(nodes: int, init_pods: int, measure_pods: int) -> List[dict]:
        ops = [_nodes_op(nodes)]
        if extra_setup is not None:
            ops.append({"opcode": "setup", "fn": extra_setup(nodes)})
        ops += [
            _volumes_setup(measure_pods, storage_class, "Immediate",
                           provisioner=provisioner, csi_driver=csi_driver,
                           offset=init_pods),
            _pods_op(init_pods, lambda i: basic_pod(i)),
            _barrier(),
            _pods_op(measure_pods, lambda i: _pvc_pod(i, f"claim-{i}"),
                     collect=True, offset=init_pods),
        ]
        return ops
    return build


def _csi_nodes_setup(nodes: int):
    """A CSINode a node with an attach limit of 39 for
    ``csi.fake.driver``."""
    def setup(store):
        for i in range(nodes):
            store.add_csi_node(CSINode(
                metadata=ObjectMeta(name=f"node-{i}"),
                drivers=[CSINodeDriver(name="csi.fake.driver",
                                       node_id=f"node-{i}",
                                       allocatable_count=39)]))
    return setup


def scheduling_shared_pvs(nodes: int, init_pods: int, measure_pods: int
                          ) -> List[dict]:
    """Three populations of measured pods:

    - 45%: shared ReadWriteMany claims on PVs of no CSI driver, ten pods
      a claim, bound;
    - 45%: unbound WaitForFirstConsumer claims, one a pod, over a pool of
      Available PVs without node affinity, bound at commit;
    - 10%: shared ReadWriteMany claims on CSI PVs, ten pods a claim.

    All three take the batch path: no CSINode publishes a limit for the
    CSI driver, so the last population has no attach column to count
    in."""
    n_serial = measure_pods // 10
    n_batch_shared = (measure_pods - n_serial) // 2
    n_wfc = measure_pods - n_serial - n_batch_shared
    n_claims = max(n_batch_shared // 10, 1)
    n_csi_claims = max(n_serial // 10, 1)

    def setup_shared(store):
        store.add_storage_class(StorageClass(
            metadata=ObjectMeta(name="shared-sc"),
            provisioner="kubernetes.io/fake",
            volume_binding_mode="Immediate"))

        def shared_pair(prefix: str, count: int, csi_driver: str = ""):
            for i in range(count):
                store.add_pv(PersistentVolume(
                    metadata=ObjectMeta(name=f"{prefix}-pv-{i}"),
                    capacity={"storage": parse_quantity("10Gi")},
                    storage_class_name="shared-sc",
                    access_modes=["ReadWriteMany"],
                    claim_ref=f"default/{prefix}-claim-{i}", phase="Bound",
                    csi_driver=csi_driver))
                store.add_pvc(PersistentVolumeClaim(
                    metadata=ObjectMeta(name=f"{prefix}-claim-{i}",
                                        namespace="default"),
                    storage_class_name="shared-sc",
                    requests={"storage": parse_quantity("1Gi")},
                    access_modes=["ReadWriteMany"],
                    volume_name=f"{prefix}-pv-{i}", phase="Bound"))
        shared_pair("shared", n_claims)
        shared_pair("csishared", n_csi_claims,
                    csi_driver="rwx.csi.example.com")

    def pod(j):
        k = j - init_pods
        if k < n_batch_shared:
            return _pvc_pod(j, f"shared-claim-{k % n_claims}")
        if k < n_batch_shared + n_wfc:
            return _pvc_pod(j, f"claim-{j}")
        return _pvc_pod(j, f"csishared-claim-{k % n_csi_claims}")

    return [
        _nodes_op(nodes),
        {"opcode": "setup", "fn": setup_shared},
        _volumes_setup(n_wfc, "unbound-sc", "WaitForFirstConsumer",
                       prebound=False, offset=init_pods + n_batch_shared),
        _pods_op(init_pods, lambda i: basic_pod(i)),
        _barrier(),
        _pods_op(measure_pods, pod, collect=True, offset=init_pods),
    ]


# pre-bound PV claims, in-tree
scheduling_in_tree_pvs = _pv_workload("intree-sc", "kubernetes.io/fake")
# the same claims served through CSI migration (the PVs name the driver)
scheduling_migrated_in_tree_pvs = _pv_workload(
    "migrated-sc", "pd.csi.storage.gke.io",
    csi_driver="pd.csi.storage.gke.io")
# CSI claims counted against CSINode attach limits of 39
scheduling_csi_pvs = _pv_workload(
    "csi-sc", "csi.fake.driver", csi_driver="csi.fake.driver",
    extra_setup=_csi_nodes_setup)


def preemption_pvs(nodes: int, init_pods: int, measure_pods: int
                   ) -> List[dict]:
    """The Preemption row with a bound claim on every preemptor: each
    evicts one priority-1 pod and keeps its claim bound."""
    return [
        _nodes_op(nodes, cpu="4", memory="8Gi"),
        _volumes_setup(measure_pods, "preempt-sc", "Immediate",
                       offset=init_pods),
        _pods_op(init_pods, lambda i: _prio(basic_pod(i, cpu="3"), 1)),
        _barrier(),
        _pods_op(measure_pods,
                 lambda i: _prio(_pvc_pod(i, f"claim-{i}", cpu="3"), 100),
                 collect=True, offset=init_pods),
    ]


WORKLOADS = {
    "SchedulingBasic": scheduling_basic,
    "SchedulingPodAntiAffinity": scheduling_pod_anti_affinity,
    "SchedulingPodAffinity": scheduling_pod_affinity,
    "SchedulingPreferredPodAffinity": scheduling_preferred_pod_affinity,
    "SchedulingPreferredPodAntiAffinity": scheduling_preferred_anti_affinity,
    "TopologySpreading": topology_spreading,
    "Preemption": preemption,
    "Unschedulable": unschedulable,
    "GangScheduling": gang_scheduling,
    "SchedulingInTreePVs": scheduling_in_tree_pvs,
    "SchedulingSharedPVs": scheduling_shared_pvs,
    "SchedulingMigratedInTreePVs": scheduling_migrated_in_tree_pvs,
    "SchedulingCSIPVs": scheduling_csi_pvs,
    "PreemptionPVs": preemption_pvs,
}


def make_workload(name: str, nodes: int, init_pods: int,
                  measure_pods: int) -> List[dict]:
    return WORKLOADS[name](nodes, init_pods, measure_pods)
