"""Benchmark workloads as op lists (the scheduler_perf op DSL):
``{"opcode": "createNodes" | "createPods" | "barrier", ...}``, at any
node and pod count. A ``createPods`` op with ``skipWaitToCompletion``
does not wait for its pods to be bound."""

from __future__ import annotations

from typing import Dict, List


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
}


def make_workload(name: str, nodes: int, init_pods: int,
                  measure_pods: int) -> List[dict]:
    return WORKLOADS[name](nodes, init_pods, measure_pods)
