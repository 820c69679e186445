"""The port's serial path against the JAX package's, on seeded mixed
batches (spread, (anti-)affinity, taints, node selectors and affinity,
host ports, ties among identical nodes): each pod gets the same node,
and each pod that fits nowhere the same ``PodScheduled=False`` reason and
message and the same nominated node. Ties are broken by the scheduler's
random draws, seeded alike on both sides (the module-level ``random`` of
the JAX package, the port's ``rng``). Also the adaptive sampling and
round-robin start index past 100 nodes, and the batch loop sending
host-port pods to the serial path in every arm. Tolerance: exact
equality.

Each pending pod is attempted once (one pass over the active queue), so
no retry depends on the backoff clock."""

import copy
import random

import numpy as np
import pytest

from kubernetes_tpu.api.types import Pod as JaxPod
from kubernetes_tpu.ops.encode import is_host_only as jax_is_host_only
from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.ops.encode import is_host_only
from test_torch_framework import (
    cluster_dicts,
    jax_scheduler,
    pending_dicts,
    pod_dict,
    port_scheduler,
)
from test_torch_pipeline import jax_arm, port_arm, pump


def outcome(store, names):
    """Per pod name: (node, PodScheduled condition, nominated node), or
    "deleted"."""
    out = {}
    for name in names:
        p = store.get_pod("default", name)
        if p is None:
            out[name] = "deleted"
            continue
        cond = [(c.status, c.reason, c.message) for c in p.status.conditions
                if c.type == "PodScheduled"]
        out[name] = (p.spec.node_name, cond, p.status.nominated_node_name)
    return out


def serial_pass(sched, ref):
    """Attempt every active pod once."""
    while sched.schedule_one(pop_timeout=0.0):
        pass
    if ref:
        assert sched.wait_for_inflight_bindings()


def run_serial(seed, pending, n_nodes=60, n_existing=40, ref=False,
               **config):
    nodes, existing = cluster_dicts(seed, n_nodes=n_nodes,
                                    n_existing=n_existing)
    if ref:
        sched = jax_scheduler(nodes, existing, **config)
        random.seed(seed)
        sched.client.create_pods([JaxPod.from_dict(copy.deepcopy(d))
                                  for d in pending])
    else:
        sched = port_scheduler(nodes, existing, seed=seed, **config)
        sched.client.create_pods([Pod.from_dict(copy.deepcopy(d))
                                  for d in pending])
    try:
        serial_pass(sched, ref)
        names = [d["metadata"]["name"] for d in pending]
        return outcome(sched.client, names), sched
    finally:
        sched.stop()


@pytest.mark.parametrize("seed", (0, 1, 2, 3, 4, 5))
def test_serial_pass_equals_the_reference(seed):
    pending = pending_dicts(seed, 40)
    got, _ = run_serial(seed, pending)
    want, _ = run_serial(seed, pending, ref=True)
    assert got == want
    placed = sum(1 for node, _, _ in got.values() if node)
    failed = [c for node, c, _ in got.values() if not node]
    assert placed > 0 and all(c and c[0][0] == "False" for c in failed)


def test_serial_pass_places_some_and_fails_some():
    """The seeded mixes reach both outcomes, with messages naming the
    filters that failed."""
    messages = set()
    for seed in range(6):
        got, _ = run_serial(seed, pending_dicts(seed, 40))
        messages.update(c[0][2] for node, c, _ in got.values() if not node)
    assert messages
    assert all(m.startswith("0/60 nodes are available: ") for m in messages)


def test_ties_follow_the_seeded_draws():
    """Identical empty nodes: every placement is a tie among them, broken
    by the seeded draws; another seed gives another map."""
    nodes = [{"metadata": {"name": f"n{i}", "labels": {}},
              "status": {"capacity": {"cpu": "8", "memory": "16Gi",
                                      "pods": "110"}}} for i in range(20)]
    rng = np.random.default_rng(5)
    pending = [pod_dict(rng, f"t{i}", features=0.0) for i in range(10)]

    def run(seed, ref):
        if ref:
            sched = jax_scheduler(nodes, [])
            random.seed(seed)
            sched.client.create_pods([JaxPod.from_dict(copy.deepcopy(d))
                                      for d in pending])
        else:
            sched = port_scheduler(nodes, [], seed=seed)
            sched.client.create_pods([Pod.from_dict(copy.deepcopy(d))
                                      for d in pending])
        serial_pass(sched, ref)
        out = outcome(sched.client, [d["metadata"]["name"] for d in pending])
        sched.stop()
        return out

    a, b = run(11, False), run(12, False)
    assert a == run(11, True) and b == run(12, True)
    assert a != b


def test_adaptive_sampling_and_round_robin_equal_the_reference():
    """Past 100 nodes the filter stops at the adaptive share of feasible
    nodes and the next pod starts where the last one stopped."""
    rng = np.random.default_rng(3)
    pending = [pod_dict(rng, f"r{i}", features=0.0) for i in range(30)]
    got, port = run_serial(3, pending, n_nodes=150, n_existing=0)
    want, ref = run_serial(3, pending, n_nodes=150, n_existing=0, ref=True)
    assert got == want
    assert port.algorithm.next_start_node_index == \
        ref.algorithm.next_start_node_index != 0
    assert port.algorithm.num_feasible_nodes_to_find(150) == 100


def test_percentage_of_nodes_to_score_equals_the_reference():
    """A configured percentage: 20% of 600 nodes are found feasible
    before a pod's filtering stops."""
    rng = np.random.default_rng(4)
    pending = [pod_dict(rng, f"q{i}", features=0.3) for i in range(20)]
    got, port = run_serial(4, pending, n_nodes=600, n_existing=0,
                           percentage_of_nodes_to_score=20)
    want, ref = run_serial(4, pending, n_nodes=600, n_existing=0, ref=True,
                           percentage_of_nodes_to_score=20)
    assert got == want
    assert port.algorithm.num_feasible_nodes_to_find(600) == 120
    assert port.algorithm.next_start_node_index == \
        ref.algorithm.next_start_node_index


# ----------------------------------------------------------------------
# the batch loop's partition: host-port pods take the serial path
def batch_arm(nodes, ref, pipeline, mirror, seed, max_batch=16,
              validate=False):
    """Either package's batch loop over ``nodes``, random draws seeded."""
    make = jax_arm if ref else port_arm
    return make(copy.deepcopy(nodes), pipeline=pipeline, mirror=mirror,
                max_batch=max_batch, seed=seed, validate=validate)


def mixed_host_port_row(seed, n_nodes=12, n_pods=60):
    """Plain pods with every fifth one asking for a host port (two port
    numbers, so some nodes run out of them)."""
    rng = np.random.default_rng(seed)
    nodes = [{"metadata": {"name": f"n{i}", "labels": {
        "kubernetes.io/hostname": f"n{i}",
        "topology.kubernetes.io/zone": f"z{i % 3}"}},
        "status": {"capacity": {"cpu": "8", "memory": "16Gi",
                                "pods": "110"}}} for i in range(n_nodes)]
    pods = []
    for i in range(n_pods):
        d = pod_dict(rng, f"m{i}", features=0.0)
        if i % 5 == 0:
            d["spec"]["containers"][0]["ports"] = [{
                "containerPort": 80, "hostPort": 8080 + (i // 5) % 2}]
        pods.append(d)
    return nodes, pods


def run_mixed(ref, pipeline, mirror, seed=2, validate=False):
    nodes, pods = mixed_host_port_row(seed)
    arm = batch_arm(nodes, ref, pipeline, mirror, seed, validate=validate)
    try:
        for wave in (pods[:30], pods[30:]):
            arm.store.create_pods([arm.pod(copy.deepcopy(d))
                                   for d in wave])
            pump(arm)
        return {p.metadata.name: p.spec.node_name
                for p in arm.store.list_pods()}
    finally:
        arm.sched.stop()


@pytest.mark.parametrize("pipeline", (True, False))
def test_host_validation_arm_like_the_reference(pipeline):
    """``validate=True``: every placement of the solve is checked by the
    host's filters before it binds (all pass here)."""
    got = run_mixed(False, pipeline, False, validate=True)
    assert got == run_mixed(True, pipeline, False, validate=True)
    assert got == run_mixed(False, pipeline, False)


@pytest.mark.parametrize("pipeline", (True, False))
@pytest.mark.parametrize("mirror", (True, False))
def test_host_port_pods_take_the_serial_path_like_the_reference(pipeline,
                                                                 mirror):
    got = run_mixed(False, pipeline, mirror)
    # the serial binds make the pipelined arm discard its held batch; the
    # JAX mirror-on arm then counts the discarded placements twice
    # (ROADMAP.md, section C), so that arm is held to the JAX mirror-off
    # arm, as the port binds alike with the mirror on and off
    want = run_mixed(True, pipeline, mirror and not pipeline)
    assert got == want
    assert all(got.values())
    # no two host-port pods with one port share a node
    ports = {}
    for name, node in got.items():
        i = int(name[1:])
        if i % 5 == 0:
            key = (node, (i // 5) % 2)
            assert key not in ports, (name, ports.get(key))
            ports[key] = name


# ----------------------------------------------------------------------
# the guards of the partition
REFUSED = {
    "claim": {"spec": {"volumes": [{"name": "v", "persistentVolumeClaim": {
        "claimName": "c"}}]}},
    "inline-disk": {"spec": {"volumes": [{"name": "v", "gcePersistentDisk": {
        "pdName": "d"}}]}},
    "mesh-block": {"metadata": {"labels": {"ktpu.io/mesh-block": "2x2"}}},
}


def _refused_pod(kind):
    d = pod_dict(np.random.default_rng(0), f"odd-{kind}", features=0.0)
    for part, extra in REFUSED[kind].items():
        for key, value in extra.items():
            if isinstance(value, dict):
                d[part].setdefault(key, {}).update(value)
            else:
                d[part][key] = value
    return d


@pytest.mark.parametrize("kind", sorted(REFUSED))
def test_pods_neither_path_takes_are_refused(kind):
    """The pods the port once refused now take the JAX package's path, in
    every arm. A claim (one the store does not hold) and an inline cloud
    disk are host-only, as the JAX package says, and take the serial
    path, where the volume plugins run (VolumeBinding finds no claim,
    VolumeRestrictions no conflict); a mesh-block pod is batchable in
    both packages (MeshLocality is a static score) and is placed: in
    every arm the same outcome as the JAX batch loop's."""
    d = _refused_pod(kind)
    name = d["metadata"]["name"]
    for pipeline in (True, False):
        got = {}
        for ref in (True, False):
            arm = batch_arm(mixed_host_port_row(0)[0], ref, pipeline, True, 0)
            host_only = (jax_is_host_only if ref else is_host_only)(
                arm.pod(copy.deepcopy(d)), arm.store, {})
            try:
                arm.store.create_pods([arm.pod(copy.deepcopy(d))])
                pump(arm)
                got[ref] = (host_only, outcome(arm.store, [name])[name])
            finally:
                arm.sched.stop()
        assert got[False] == got[True]
        host_only, (node, cond, _) = got[False]
        assert host_only == (kind != "mesh-block")
        if kind == "claim":
            assert not node and "persistentvolumeclaim not found" in \
                cond[0][2]
        else:
            assert node


def test_host_port_pods_are_host_only():
    _, pods = mixed_host_port_row(0, n_pods=10)
    assert [is_host_only(Pod.from_dict(d)) for d in pods] == [
        i % 5 == 0 for i in range(10)]
