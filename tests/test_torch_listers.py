"""SelectorSpread on the serial path with the controller objects in the
store: a Service, ReplicaSet, ReplicationController or StatefulSet
selecting pending pods spreads them away from the nodes that already run
its pods, in the port as in the JAX package. The nodes are loaded alike
(a pod of another app sits on each node without one of the selected
pods), so no other score tells them apart. Tolerance: exact equality of
every placement."""

import copy
import random

import pytest

from kubernetes_tpu.api import types as jax_types
from kubernetes_tpu.api.labels import LabelSelector as JaxLabelSelector
from kubernetes_tpu.apiserver.store import ClusterStore as JaxStore
from kubernetes_tpu_torch.api import types as port_types
from kubernetes_tpu_torch.api.labels import LabelSelector
from kubernetes_tpu_torch.apiserver.store import ClusterStore
from test_torch_framework import jax_scheduler, port_scheduler

ZONE = "topology.kubernetes.io/zone"
APP = {"app": "web"}


def node(i):
    return {"metadata": {"name": f"n{i}", "labels": {
        "kubernetes.io/hostname": f"n{i}", ZONE: f"z{i % 2}"}},
        "status": {"capacity": {"cpu": "8", "memory": "16Gi",
                                "pods": "110"}}}


def pod(name, labels, node_name=""):
    return {"metadata": {"name": name, "uid": f"u-{name}",
                         "labels": dict(labels)},
            "spec": {"nodeName": node_name, "containers": [{
                "name": "c", "resources": {"requests": {
                    "cpu": "500m", "memory": "256Mi"}}}]}}


def controller(kind, types, selector_cls):
    meta = types.ObjectMeta(name=f"{kind}-web", namespace="default")
    if kind == "service":
        return "add_service", types.Service(meta, selector=dict(APP))
    if kind == "rc":
        return ("add_replication_controller",
                types.ReplicationController(meta, selector=dict(APP)))
    sel = selector_cls(match_labels=dict(APP))
    if kind == "replicaset":
        return "add_replica_set", types.ReplicaSet(meta, selector=sel)
    return "add_stateful_set", types.StatefulSet(meta, selector=sel)


def run(kind, ref, seed, with_controller=True):
    nodes = [node(i) for i in range(8)]
    # three web pods on n0, n2, n5; a pod of another app on the others
    existing = [pod(f"e{i}", APP if i in (0, 2, 5) else {"app": "db"},
                    f"n{i}") for i in range(8)]
    pending = [pod(f"p{i}", APP) for i in range(5)]
    if ref:
        sched = jax_scheduler(nodes, existing)
        random.seed(seed)
        types, sel_cls = jax_types, JaxLabelSelector
    else:
        sched = port_scheduler(nodes, existing, seed=seed)
        types, sel_cls = port_types, LabelSelector
    store = sched.client
    if with_controller:
        add, obj = controller(kind, types, sel_cls)
        getattr(store, add)(obj)
    make = types.Pod.from_dict
    try:
        for d in pending:
            store.create_pods([make(copy.deepcopy(d))])
            while sched.schedule_one(pop_timeout=0.0):
                pass
            if ref:
                assert sched.wait_for_inflight_bindings()
        return {d["metadata"]["name"]: store.get_pod(
            "default", d["metadata"]["name"]).spec.node_name
            for d in pending}
    finally:
        sched.stop()


@pytest.mark.parametrize("kind", ("service", "replicaset", "rc",
                                  "statefulset"))
@pytest.mark.parametrize("seed", (0, 1, 2))
def test_selected_pods_spread_like_the_reference(kind, seed):
    got = run(kind, False, seed)
    want = run(kind, True, seed)
    assert got == want
    # the first pending pod avoids every node with a web pod, and the
    # five land on five distinct nodes
    assert got["p0"] not in ("n0", "n2", "n5")
    assert len(set(got.values())) == 5


def test_listers_return_the_namespace_objects():
    """Each lister returns its kind's objects of one namespace, as the
    JAX store's do."""
    for ns in ("default", "other"):
        stores = []
        for types, sel_cls, store in (
                (jax_types, JaxLabelSelector, JaxStore()),
                (port_types, LabelSelector, ClusterStore())):
            for kind in ("service", "replicaset", "rc", "statefulset"):
                add, obj = controller(kind, types, sel_cls)
                getattr(store, add)(obj)
                add, obj = controller(kind, types, sel_cls)
                obj.metadata.namespace = "other"
                obj.metadata.name += "-2"
                getattr(store, add)(obj)
            stores.append(store)
        for lister in ("list_services", "list_replica_sets",
                       "list_replication_controllers",
                       "list_stateful_sets"):
            names = [sorted(o.metadata.name for o in getattr(s, lister)(ns))
                     for s in stores]
            assert names[0] == names[1] and len(names[0]) == 1
