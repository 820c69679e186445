"""The port's encoder equals the JAX package's: the same Pod and Node
dicts give identical EncodedCluster, EncodedBatch and (pod-side only)
EncodedPodBatch arrays."""

import numpy as np
import pytest

from kubernetes_tpu.api import types as jax_types
from kubernetes_tpu.api.types import Node as JaxNode, Pod as JaxPod
from kubernetes_tpu.apiserver.store import ClusterStore as JaxStore
from kubernetes_tpu.ops.encode import (
    BatchEncoder as JaxEncoder,
    is_host_only as jax_is_host_only,
)
from kubernetes_tpu.scheduler.snapshot import new_snapshot as jax_snapshot
from kubernetes_tpu_torch.api import types as port_types
from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.ops.encode import (
    BatchEncoder,
    InexpressiblePodError,
    is_host_only,
)
from kubernetes_tpu_torch.scheduler.snapshot import new_snapshot
from test_torch_cases import mixed_cluster, mixed_pods, pod, wide_pods

CLUSTER_FIELDS = ("node_names", "num_real_nodes", "resource_names",
                  "allocatable", "requested", "nonzero_requested",
                  "pod_count", "max_pods", "topo_keys", "topo_codes",
                  "topo_num_values")
POD_FIELDS = ("num_real_pods", "requests", "nonzero_requests", "profile_idx",
              "inexpressible", "pod_sc", "pod_sc_match", "match_by",
              "own_aff", "own_anti", "pref_weight")
BATCH_FIELDS = POD_FIELDS + (
    "static_masks", "affinity_masks", "static_scores", "sc_key_idx",
    "sc_max_skew", "sc_hard", "sc_counts", "sc_domain", "term_key_idx",
    "term_counts", "term_owners", "num_values")


def _assert_fields_equal(got, ref, fields):
    for f in fields:
        a, b = getattr(got, f), getattr(ref, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f


def encoders(node_dicts, existing):
    port = BatchEncoder(new_snapshot([Pod.from_dict(p) for p in existing],
                                     [Node.from_dict(n) for n in node_dicts]))
    ref = JaxEncoder(jax_snapshot([JaxPod.from_dict(p) for p in existing],
                                  [JaxNode.from_dict(n) for n in node_dicts]),
                     pad_nodes=128)
    return port, ref


@pytest.mark.parametrize("case", ["mixed", "wide"])
def test_encode_matches_reference(case):
    nodes, existing = mixed_cluster()
    pods = mixed_pods() if case == "mixed" else wide_pods()
    port, ref = encoders(nodes, existing)
    got_c, got_b = port.encode([Pod.from_dict(p) for p in pods], pad_pods=32)
    ref_c, ref_b = ref.encode([JaxPod.from_dict(p) for p in pods],
                              pad_pods=32)
    _assert_fields_equal(got_c, ref_c, CLUSTER_FIELDS)
    _assert_fields_equal(got_b, ref_b, BATCH_FIELDS)


def test_encode_pods_only_matches_reference():
    nodes, existing = mixed_cluster()
    first = mixed_pods()
    port, ref = encoders(nodes, existing)
    port.encode([Pod.from_dict(p) for p in first], pad_pods=32)
    ref.encode([JaxPod.from_dict(p) for p in first], pad_pods=32)
    # a later batch inside the same space, in another order, and one that
    # leaves it (an untracked constraint): both encoders agree on None
    later = mixed_pods(n=13, prefix="q")[::-1]
    got = port.encode_pods_only([Pod.from_dict(p) for p in later], 16)
    want = ref.encode_pods_only([JaxPod.from_dict(p) for p in later], 16)
    _assert_fields_equal(got, want, POD_FIELDS)
    outside = later + [pod("x", spread=[(3, "kubernetes.io/hostname",
                                         "DoNotSchedule", {"app": "x"})])]
    assert port.encode_pods_only([Pod.from_dict(p) for p in outside],
                                 16) is None
    assert ref.encode_pods_only([JaxPod.from_dict(p) for p in outside],
                                16) is None


def _bound_claim(store, types):
    """Claim ``c`` bound to PV ``pv-c`` in ``store`` (either package's
    storage ``types``)."""
    store.add_pv(types.PersistentVolume(
        metadata=types.ObjectMeta(name="pv-c"), claim_ref="default/c",
        phase="Bound"))
    store.add_pvc(types.PersistentVolumeClaim(
        metadata=types.ObjectMeta(name="c", namespace="default"),
        volume_name="pv-c", phase="Bound"))


@pytest.mark.parametrize("spec", [
    {"volumes": [{"name": "v", "persistentVolumeClaim": {"claimName": "c"}}]},
    {"containers": [{"name": "c", "ports": [{"containerPort": 80,
                                             "hostPort": 8080}]}]},
])
def test_inexpressible_pods_raise(spec):
    """Without a store every claim is host-only, and so is a host port,
    in both packages; the port's encoder raises for a host-only pod. With
    a store holding the claim bound to a PV, the claim pod is not
    host-only in either package, and both encoders take it alike."""
    nodes, existing = mixed_cluster()
    port, _ = encoders(nodes, existing)
    d = pod("odd")
    d["spec"].update(spec)
    assert is_host_only(Pod.from_dict(d)) and jax_is_host_only(
        JaxPod.from_dict(d))
    with pytest.raises(InexpressiblePodError):
        port.encode([Pod.from_dict(d)], pad_pods=8)
    stores = (ClusterStore(), JaxStore())
    _bound_claim(stores[0], port_types)
    _bound_claim(stores[1], jax_types)
    host_only = is_host_only(Pod.from_dict(d), stores[0])
    assert host_only == jax_is_host_only(JaxPod.from_dict(d), stores[1]) \
        == ("containers" in spec)
    if not host_only:
        port = BatchEncoder(new_snapshot(
            [Pod.from_dict(p) for p in existing],
            [Node.from_dict(n) for n in nodes]), stores[0])
        ref = JaxEncoder(jax_snapshot(
            [JaxPod.from_dict(p) for p in existing],
            [JaxNode.from_dict(n) for n in nodes]), pad_nodes=128,
            client=stores[1])
        got = port.encode([Pod.from_dict(d)], pad_pods=8)
        want = ref.encode([JaxPod.from_dict(d)], pad_pods=8)
        _assert_fields_equal(got[0], want[0], CLUSTER_FIELDS)
        _assert_fields_equal(got[1], want[1], BATCH_FIELDS)
