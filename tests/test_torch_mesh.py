"""MeshLocality in the port against the JAX package: gangs labelled with
a mesh block on a labelled grid of nodes are placed alike on the batch
path (the closeness is a static score and the block part of the static
profile key) and on the serial path (the Score plugin), with the gang
scheduling provider on both sides. Also the plugin's scores and the
encoder's static scores, node by node. Tolerance: exact equality."""

import copy
from types import SimpleNamespace

import numpy as np
import pytest

from kubernetes_tpu.api.types import Node as JaxNode, Pod as JaxPod
from kubernetes_tpu.ops.encode import BatchEncoder as JaxEncoder
from kubernetes_tpu.scheduler.framework.plugins import (
    mesh_locality as jax_mesh,
)
from kubernetes_tpu.scheduler.snapshot import new_snapshot as jax_snapshot
from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.ops.encode import BatchEncoder, is_host_only
from kubernetes_tpu_torch.scheduler.framework.plugins import mesh_locality
from kubernetes_tpu_torch.scheduler.snapshot import new_snapshot
from test_torch_gang import (
    create,
    drain,
    gang_pod,
    jax_gang_scheduler,
    port_gang_scheduler,
)
from test_torch_pipeline import bound_set, pump

COLS, ROWS = 6, 6


def mesh_node(i, cpu="4"):
    labels = {"kubernetes.io/hostname": f"n{i}"}
    labels.update(mesh_locality.mesh_node_labels(i, COLS, ROWS))
    return {"metadata": {"name": f"n{i}", "labels": labels},
            "status": {"capacity": {"cpu": cpu, "memory": "16Gi",
                                    "pods": "110"}}}


def mesh_gangs(seed, n_gangs=6, size=4):
    """Gangs of ``size`` one-cpu members, each gang its own mesh block,
    and a few unlabelled pods."""
    rng = np.random.default_rng(seed)
    out = []
    for g in range(n_gangs):
        for m in range(size):
            d = gang_pod(f"g{g}-{m}", f"g{g}", size,
                         cpu=str(int(rng.integers(1, 3))))
            d["metadata"]["labels"][mesh_locality.MESH_BLOCK_LABEL] = \
                f"block-{seed}-{g}"
            out.append(d)
    out += [gang_pod(f"plain-{i}", None, 0) for i in range(4)]
    return out


def ring(name, node_name):
    """The Manhattan distance of ``node_name`` from the pod's anchor."""
    i = int(node_name[1:])
    x, y = i % COLS, i // COLS
    block = f"block-{name}"
    ax, ay = mesh_locality.block_anchor(block, COLS, ROWS)
    return abs(x - ax) + abs(y - ay)


def mean_ring(placed, seed):
    """Mean distance of the gang members from their blocks' anchors."""
    rings = [ring(f"{seed}-{name.split('-')[0][1:]}", node_name)
             for name, node_name in placed.items() if name.startswith("g")]
    return sum(rings) / len(rings)


def run_arm(make, nodes, dicts, seed, path):
    arm = make(nodes, seed=seed, batch=64 if path == "batch" else None)
    try:
        create(arm, dicts)
        if path == "batch":
            pump(arm)
        else:
            drain(arm)
        return bound_set(arm)
    finally:
        arm.sched.stop()


@pytest.mark.parametrize("seed", (0, 1, 2))
@pytest.mark.parametrize("path", ("batch", "serial"))
def test_mesh_gangs_placed_like_the_reference(seed, path):
    nodes = [mesh_node(i) for i in range(COLS * ROWS)]
    dicts = mesh_gangs(seed)
    got = run_arm(port_gang_scheduler, nodes, dicts, seed, path)
    want = run_arm(jax_gang_scheduler, nodes, dicts, seed, path)
    assert got == want
    placed = dict(got)
    assert all(placed.values())
    # the members sit closer to their anchors than with the scoring off
    mesh_locality.configure(False)
    try:
        blind = dict(run_arm(port_gang_scheduler, nodes, dicts, seed, path))
    finally:
        mesh_locality.configure(True)
    assert mean_ring(placed, seed) < mean_ring(blind, seed)


def test_mesh_pod_is_batchable_in_both_packages():
    d = mesh_gangs(0)[0]
    from kubernetes_tpu.ops.encode import is_host_only as jax_is_host_only
    assert not is_host_only(Pod.from_dict(copy.deepcopy(d)))
    assert not jax_is_host_only(JaxPod.from_dict(copy.deepcopy(d)))


@pytest.mark.parametrize("enabled", (True, False))
def test_static_scores_and_profiles_equal_the_reference(enabled):
    """The encoders' static scores and profile split over a grid with
    some unlabelled nodes, the switch on and off."""
    nodes = [mesh_node(i) for i in range(30)]
    for d in nodes[::7]:
        for key in (mesh_locality.MESH_X_LABEL, mesh_locality.MESH_Y_LABEL):
            d["metadata"]["labels"].pop(key)
    dicts = mesh_gangs(3, n_gangs=3, size=2)
    mesh_locality.configure(enabled)
    jax_mesh.configure(enabled)
    try:
        port = BatchEncoder(new_snapshot(
            [], [Node.from_dict(copy.deepcopy(d)) for d in nodes]))
        ref = JaxEncoder(jax_snapshot(
            [], [JaxNode.from_dict(copy.deepcopy(d)) for d in nodes]))
        _, pb = port.encode([Pod.from_dict(copy.deepcopy(d))
                             for d in dicts], pad_pods=16)
        _, rb = ref.encode([JaxPod.from_dict(copy.deepcopy(d))
                            for d in dicts], pad_pods=16)
    finally:
        mesh_locality.configure(True)
        jax_mesh.configure(True)
    assert pb.static_scores.dtype == rb.static_scores.dtype
    np.testing.assert_array_equal(pb.static_scores, rb.static_scores)
    np.testing.assert_array_equal(pb.profile_idx, rb.profile_idx)
    assert (pb.static_scores.max() > 0) == enabled


def test_score_plugin_equals_the_reference():
    """The Score plugin of both packages, pod by pod and node by node."""
    nodes = [mesh_node(i) for i in range(COLS * ROWS)]
    dicts = mesh_gangs(1, n_gangs=3, size=1)
    port_snap = new_snapshot(
        [], [Node.from_dict(copy.deepcopy(d)) for d in nodes])
    ref_snap = jax_snapshot(
        [], [JaxNode.from_dict(copy.deepcopy(d)) for d in nodes])
    pp = mesh_locality.MeshLocality.factory(
        None, SimpleNamespace(snapshot=lambda: port_snap))
    rp = jax_mesh.MeshLocality.factory(
        None, SimpleNamespace(snapshot=lambda: ref_snap))
    for d in dicts:
        a = Pod.from_dict(copy.deepcopy(d))
        b = JaxPod.from_dict(copy.deepcopy(d))
        scores = [pp.score(None, a, n["metadata"]["name"]) for n in nodes]
        assert scores == [rp.score(None, b, n["metadata"]["name"])
                          for n in nodes]
        assert max(s for s, _ in scores) == (
            100 if mesh_locality.mesh_block(a) else 0)
