"""The session's state-only rebuild in the port against the JAX package:
the same sequence (a wave, victim deletions, another wave, a pod bound
by the serial path, a third wave) through both batch loops with the
device mirror off, so each outside mutation makes the next solve
rebuild; the static fingerprint is unchanged, so the rebuild uploads the
state planes alone. The same ``rebuilds`` and ``state_only_rebuilds``,
the same pods on the same nodes, and the carried state planes equal bit
for bit. Then the port's resident static planes against a fresh
``prepare``, and the cases that must upload everything again (a new
node, a drift). Tolerance: exact equality."""

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.api.types import Node
from kubernetes_tpu_torch.ops.encode import BatchEncoder
from kubernetes_tpu_torch.ops.planes import prepare
from kubernetes_tpu_torch.scheduler.snapshot import Snapshot
from test_torch_pipeline import (
    bound_set,
    jax_arm,
    node_dict,
    pod_dict,
    port_arm,
    pump,
    stop,
)


def _host_port_pod(name):
    d = pod_dict(name, "500m")
    d["spec"]["containers"][0]["ports"] = [{"containerPort": 80,
                                           "hostPort": 8080}]
    return d


def _wave(w, n=12):
    return [pod_dict(f"w{w}-p{i}", "1") for i in range(n)]


def _sequence(make_arm):
    """(per step: rebuilds, state-only rebuilds; the bound set; the
    carried state planes as numpy)."""
    # seeded: the serial path breaks score ties at random
    arm = make_arm([node_dict(i) for i in range(10)], pipeline=False,
                   mirror=False, max_batch=32, seed=3)
    steps = []

    def step():
        pump(arm)
        s = arm.bs.session
        steps.append((s.rebuilds, s.state_only_rebuilds))

    try:
        arm.store.create_pods([arm.pod(d) for d in _wave(0)])
        step()
        for name in ("w0-p1", "w0-p4", "w0-p7"):
            arm.store.delete_pod("default", name)
        arm.store.create_pods([arm.pod(d) for d in _wave(1)])
        step()
        arm.store.create_pods([arm.pod(_host_port_pod("hp"))])
        step()
        arm.store.create_pods([arm.pod(d) for d in _wave(2)])
        step()
        state = arm.bs.session._state
        planes = state.numpy() if isinstance(state, torch.Tensor) \
            else np.asarray(state.planes)
        return steps, bound_set(arm), planes
    finally:
        stop(arm)


def test_state_only_rebuilds_match_the_reference():
    got_steps, got_bound, got_planes = _sequence(port_arm)
    want_steps, want_bound, want_planes = _sequence(jax_arm)
    assert got_steps == want_steps
    assert got_steps[-1][1] >= 2 and got_steps[0] == (1, 0)
    assert got_bound == want_bound
    assert all(n for _, n in got_bound)
    assert got_planes.dtype == np.int32
    np.testing.assert_array_equal(
        got_planes, want_planes.reshape(got_planes.shape))


def _session_after_state_only():
    arm = port_arm([node_dict(i) for i in range(6)], pipeline=False,
                   mirror=False, max_batch=16)
    arm.store.create_pods([arm.pod(d) for d in _wave(0, 8)])
    pump(arm)
    arm.store.delete_pod("default", "w0-p2")
    arm.store.create_pods([arm.pod(d) for d in _wave(1, 8)])
    pump(arm)
    return arm


def test_resident_static_planes_equal_a_fresh_prepare():
    arm = _session_after_state_only()
    try:
        s = arm.bs.session
        assert s.state_only_rebuilds == 1
        pods = [arm.pod(d) for d in _wave(9, 8)]
        fresh, _ = s.fresh_planes(pods, 16)
        assert s._static[3:] == fresh[3:]
        for a, b in zip(s._static[:3], fresh[:3]):
            assert torch.equal(a, b)
    finally:
        stop(arm)


def test_state_only_counts_only_the_state_planes_bytes():
    arm = _session_after_state_only()
    try:
        s = arm.bs.session
        backend = s.backend
        pods = [arm.pod(d) for d in _wave(9, 8)]
        snap = Snapshot()
        s.sched.cache.update_snapshot(snap)
        c, b = BatchEncoder(snap, s.sched.client).encode(pods, pad_pods=16)
        backend.take_transfer_bytes()
        state = backend.prepare_state_only(c, b)
        only = backend.take_transfer_bytes()["h2d"]
        ps, full_state = backend.prepare(c, b)
        full = backend.take_transfer_bytes()["h2d"]
        assert only == state.numel() * 4
        assert full == only + sum(t.numel() * t.element_size()
                                  for t in ps[:3])
        assert torch.equal(state, full_state)
        assert torch.equal(state, prepare(c, b, "cpu")[1])
    finally:
        stop(arm)


@pytest.mark.parametrize("change", ["new node", "drift"])
def test_static_change_uploads_everything(change):
    arm = port_arm([node_dict(i) for i in range(6)], pipeline=False,
                   mirror=False, max_batch=16)
    try:
        arm.store.create_pods([arm.pod(d) for d in _wave(0, 8)])
        pump(arm)
        if change == "new node":
            arm.store.add_node(Node.from_dict(node_dict(6)))
        else:
            arm.bs.session.note_drift()
        arm.store.create_pods([arm.pod(d) for d in _wave(1, 8)])
        pump(arm)
        s = arm.bs.session
        assert (s.rebuilds, s.state_only_rebuilds) == (2, 0)
    finally:
        stop(arm)
