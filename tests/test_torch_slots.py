"""The sparse term-slot route against the JAX package: the port's pack
(``ops/slots.py``) equals the reference's ``pack_sparse_slots`` array for
array; the plain slot solve equals the reference's sparse scan
(``_xla_planes_solve_sparse``) and the port's dense plain solve, on the
assignments and the final planes, bit for bit, with the state carried
across batches; and the SchedulingPodAntiAffinity and
SchedulingPreferredPodAntiAffinity rows, which both packages route to the
slot solve, place every pod on the node the JAX harness picks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.harness import perf as jax_perf
from kubernetes_tpu.harness import workloads as jax_workloads
from kubernetes_tpu.ops import pallas_solver as jps
from kubernetes_tpu.ops.solver import SolverParams as JaxParams
from kubernetes_tpu_torch.harness import perf, workloads
from kubernetes_tpu_torch.harness.problems import (
    cache_slot_planes,
    random_slot_planes,
)
from kubernetes_tpu_torch.ops import slots as slots_mod
from kubernetes_tpu_torch.ops import solve as solve_mod
from kubernetes_tpu_torch.ops.solve import solve_plain, solve_plain_slots
from kubernetes_tpu_torch.ops.slots import SPARSE_K
from kubernetes_tpu_torch.ops.solver import SolverParams
from test_torch_pipeline import port_arm, pump, stop

PARAMS = SolverParams()
R, SC = 3, 2


def dense_stream(seed, b, t, refs=8):
    """A seeded dense pod stream at ``t`` terms: each pod references at
    most ``refs`` of them (matched, required affinity or anti-affinity,
    preferred weights of either sign)."""
    rng = np.random.default_rng(seed)
    c = R + 4 + 2 * SC
    ints = np.zeros((b, c + 3 * t), dtype=np.int32)
    ints[:, :c] = rng.integers(0, 3, (b, c))
    floats = np.zeros((b, t), dtype=np.float32)
    for i in range(b):
        m = refs if i == 0 else int(rng.integers(0, refs + 1))
        for k in rng.choice(t, m, replace=False):
            kind = int(rng.integers(5))
            if kind < 3:
                ints[i, c + kind * t + k] = 1
            else:
                floats[i, k] = float(rng.choice([-10, -2, 1, 3, 10]))
            if rng.random() < 0.3:
                ints[i, c + k] = 1          # matched too
    return ints, floats


@pytest.mark.parametrize("t", [12, 40, 100])
def test_pack_matches_reference(t):
    ints, floats = dense_stream(t, 96, t)
    want = jps.pack_sparse_slots(ints, floats, R, SC, t)
    got = slots_mod.pack_sparse_slots(ints, floats, R, SC, t)
    assert want is not None and len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    base, idx, flags, w = got
    assert ((flags != 0) | (w != 0)).sum(1).max() == slots_mod.SPARSE_K
    assert (w < 0).any() and (w > 0).any()
    # the slot stream: base | index | flags, and the weights
    stream, weights = slots_mod.slot_stream(ints, floats, R, SC, t)
    assert stream.shape == (96, slots_mod.slot_width(R, SC))
    np.testing.assert_array_equal(stream, np.concatenate([base, idx, flags],
                                                         axis=1))
    np.testing.assert_array_equal(weights, w)
    # a pod with nine references packs in neither package
    ints9, floats9 = dense_stream(t + 1, 8, t, refs=9)
    assert jps.pack_sparse_slots(ints9, floats9, R, SC, t) is None
    assert slots_mod.pack_sparse_slots(ints9, floats9, R, SC, t) is None
    assert slots_mod.slot_stream(ints9, floats9, R, SC, t) is None


def _jax_sparse(ps, planes, ints, floats):
    """The reference's sparse scan on the port's planes; returns
    (assignments, final planes) as numpy."""
    nb = ps.ints.shape[1] // 128
    base, idx, flags, w = jps.pack_sparse_slots(ints, floats, ps.r, ps.sc,
                                                ps.t)
    new, assign = jps._xla_planes_solve_sparse(
        JaxParams(), ps.r, ps.sc, ps.t, ps.u, ps.v,
        jnp.asarray(ps.sc_meta.numpy()),
        jnp.asarray(ps.ints.numpy().reshape(-1, nb, 128)),
        jnp.asarray(ps.f32s.numpy().reshape(ps.u, nb, 128)),
        jnp.asarray(planes.reshape(planes.shape[0], nb, 128)),
        jnp.asarray(base), jnp.asarray(idx), jnp.asarray(flags),
        jnp.asarray(w))
    return np.asarray(assign), np.asarray(new).reshape(planes.shape)


@pytest.mark.parametrize("seed,t", [(0, 100), (1, 100), (2, 12)])
def test_plain_slots_match_the_sparse_scan_and_the_dense_solve(seed, t):
    """Two batches carrying the state: the slot solve, the reference's
    sparse scan and the dense plain solve agree on every assignment and
    every plane. The batches hold pods with several preferred weights
    and pods of fresh affinity groups (the first-pod rule)."""
    ps, state, ints, floats = random_slot_planes(seed, 256, 128, t, sc=2,
                                                 u=2, real=240)
    ints, floats = ints.numpy(), floats.numpy()
    dense_state = state.clone()
    ref_planes = state.numpy().copy()
    c = ps.r + 4 + 2 * ps.sc
    weighted = (floats != 0).sum(1)
    assert weighted.max() >= 3
    group_pods = (ints[:, c:c + 2] & ints[:, c + t:c + t + 2]).any(1) \
        & (ints[:, ps.r + 3] > 0)
    assert group_pods.sum() >= 8
    placed = []
    for lo, hi in ((0, 64), (64, 128)):
        stream = slots_mod.slot_stream(ints[lo:hi], floats[lo:hi], ps.r,
                                       ps.sc, t)
        assert stream is not None
        got = solve_plain_slots(PARAMS, ps, state,
                                *(torch.from_numpy(a) for a in stream))
        want, ref_planes = _jax_sparse(ps, ref_planes, ints[lo:hi],
                                       floats[lo:hi])
        dense = solve_plain(PARAMS, ps, dense_state,
                            torch.from_numpy(ints[lo:hi]),
                            torch.from_numpy(floats[lo:hi]))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(state.numpy(), ref_planes)
        np.testing.assert_array_equal(got.numpy(), dense.numpy())
        np.testing.assert_array_equal(state.numpy(), dense_state.numpy())
        assert (got >= 0).sum() > 16
        placed.extend(got.tolist())
    # the fresh groups' pods were placed: the first of each by the
    # first-pod rule
    assert (np.array(placed)[group_pods] >= 0).sum() >= 4


@pytest.mark.parametrize("seed,t,chunk", [(5, 100, 3), (6, 200, 3),
                                           (7, 100, 1)])
def test_plain_slots_match_the_sparse_scan_on_the_cache_stress_stream(
        seed, t, chunk):
    """The stream that works the slot kernel's term-row cache
    (``cache_slot_planes``: eight references a pod, two shared with the
    pod before, chunks walking through all T terms, every fourth chunk
    back on the terms of the chunk three before): the slot solve, the
    reference's sparse scan and the dense plain solve agree on every
    assignment and plane, and the commits it shares between pods land."""
    ps, state, ints, floats = cache_slot_planes(seed, 256, 96, t, chunk,
                                                sc=2, u=2, real=240)
    ints, floats = ints.numpy(), floats.numpy()
    stream = slots_mod.slot_stream(ints, floats, ps.r, ps.sc, t)
    assert stream is not None
    active = (stream[0][:, -SPARSE_K:] != 0) | (stream[1] != 0)
    assert (active.sum(1) == SPARSE_K).all()
    assert len(set(stream[0][:, -2 * SPARSE_K:-SPARSE_K][active])) == t
    dense_state = state.clone()
    ref_planes = state.numpy().copy()
    got = solve_plain_slots(PARAMS, ps, state,
                            *(torch.from_numpy(a) for a in stream))
    want, ref_planes = _jax_sparse(ps, ref_planes, ints, floats)
    dense = solve_plain(PARAMS, ps, dense_state, torch.from_numpy(ints),
                        torch.from_numpy(floats))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(state.numpy(), ref_planes)
    np.testing.assert_array_equal(got.numpy(), dense.numpy())
    np.testing.assert_array_equal(state.numpy(), dense_state.numpy())
    assert (got >= 0).sum() > 48


def _routes(monkeypatch):
    """Count the port's dense and slot solves."""
    calls = {"dense": 0, "slots": 0}
    real_dense, real_slots = solve_mod.solve_plain, solve_mod.solve_plain_slots

    def dense(*a):
        calls["dense"] += 1
        return real_dense(*a)

    def slots(*a):
        calls["slots"] += 1
        return real_slots(*a)

    monkeypatch.setattr(solve_mod, "solve_plain", dense)
    monkeypatch.setattr(solve_mod, "solve_plain_slots", slots)
    return calls


@pytest.mark.parametrize("name", ["SchedulingPodAntiAffinity",
                                  "SchedulingPreferredPodAntiAffinity"])
def test_wide_term_rows_match_the_reference(name, monkeypatch):
    """600 nodes / 100 / 400 at T = 100: past the dense cluster layout,
    so the port solves the measured batches on the slot route, as the
    reference does on its sparse scan; every pod on the same node."""
    nodes, init, pods = 600, 100, 400
    sparse = []
    real_sparse = jps._xla_planes_solve_sparse

    def counted(*a, **kw):
        sparse.append(1)
        return real_sparse(*a, **kw)

    monkeypatch.setattr(jps, "_xla_planes_solve_sparse", counted)
    placed = {}

    def hook(sched, _bs):
        placed.update({p.metadata.name: p.spec.node_name
                       for p in sched.client.list_pods()})

    jax_perf.run_workload(
        name, jax_workloads.make_workload(name, nodes, init, pods),
        use_batch=True, backend_factory=jps.XlaPlanesBackend,
        adaptive_chunk=False, max_batch=128, result_hook=hook)
    calls = _routes(monkeypatch)
    res = perf.run_workload(name, workloads.make_workload(name, nodes, init,
                                                          pods),
                            device="cpu", max_batch=128)
    assert len(res.placements) == init + pods
    assert all(res.placements.values())
    assert res.placements == placed
    assert calls["slots"] >= pods // 128 and len(sparse) >= pods // 128
    if name == "SchedulingPodAntiAffinity":
        colours = {(res.placements[f"pod-{i}"], i % 100)
                   for i in range(init, init + pods)}
        assert len(colours) == pods


def test_backend_routes_by_plan_and_pack():
    """The backend takes the slot stream only at T >= 12, past the dense
    cluster layout, when every pod packs."""
    route = solve_mod.CudaPlanesBackend.slot_route
    wide = random_slot_planes(3, 5120, 32, 100)
    ps, _, ints, floats = wide
    stream = route(ps, ints.numpy(), floats.numpy())
    assert stream is not None
    assert stream[0].shape == (32, slots_mod.slot_width(ps.r, ps.sc))
    # a pod of nine references: the dense stream (the wide kernel)
    nine = ints.numpy().copy()
    c = ps.r + 4 + 2 * ps.sc
    nine[1, c:c + 9] = 1
    assert route(ps, nine, floats.numpy()) is None
    assert solve_mod.plan_batch(ps).kernel == "wide"
    # narrow planes the dense cluster layout takes, and few terms
    for args in (random_slot_planes(4, 256, 32, 100),
                 random_slot_planes(5, 5120, 32, 11)):
        assert route(args[0], args[2].numpy(), args[3].numpy()) is None
        assert solve_mod.plan_batch(args[0]).kernel == "cluster"


def test_discard_of_a_held_slot_batch_loses_nothing(monkeypatch):
    """A bound pod deleted while a slot-route batch is held: the
    pipelined arm discards the batch and invalidates the session (the
    slot solve updated the state in place), rebuilds, and binds every
    pod, no two of one colour on a node."""
    ops = workloads.scheduling_pod_anti_affinity(600, 0, 192)
    template = ops[3]["podTemplate"]
    arm = port_arm([workloads.node_template(i) for i in range(600)],
                   max_batch=64)
    try:
        arm.store.create_pods([arm.pod(template(i)) for i in range(64)])
        pump(arm)
        calls = _routes(monkeypatch)
        arm.store.create_pods([arm.pod(template(i))
                               for i in range(64, 192)])
        arm.bs.run_batch(pop_timeout=0.1)
        assert arm.bs.holding and calls["slots"] == 1
        session = arm.bs.session
        rebuilds = session.rebuilds
        arm.store.delete_pod("default", "pod-3")
        pump(arm)
        assert arm.bs.discards == 1 and session.rebuilds > rebuilds
        assert calls["slots"] >= 3 and calls["dense"] == 0
        pods = arm.store.list_pods()
        assert len(pods) == 191 and all(p.spec.node_name for p in pods)
        pairs = {(p.spec.node_name, p.metadata.labels["color"])
                 for p in pods}
        assert len(pairs) == 191
    finally:
        stop(arm)


def test_wide_pods_take_the_dense_route_and_match_the_reference(
        monkeypatch):
    """``chip_smoke.py``'s phase 28 workload at 600 nodes / 100 / 400,
    every 16th measured pod with 12 weighted pod-affinity terms beside
    its anti-affinity (13 references): no measured batch packs, so the
    port solves them on the dense stream its plan gives the wide kernel
    (the plain version stands in for it here), as the reference takes
    its dense scan; every pod on the node the JAX harness picks, no node
    with two measured pods of one colour."""
    from chip_smoke import wide_pods_workload

    nodes, init, pods, every = 600, 100, 400, 16
    dense_jax = []
    real_dense = jps._xla_planes_solve

    def counted(*a, **kw):
        dense_jax.append(1)
        return real_dense(*a, **kw)

    monkeypatch.setattr(jps, "_xla_planes_solve", counted)
    placed = {}

    def hook(sched, _bs):
        placed.update({p.metadata.name: p.spec.node_name
                       for p in sched.client.list_pods()})

    jax_perf.run_workload(
        "SchedulingPodAntiAffinity",
        wide_pods_workload(jax_workloads, nodes, init, pods, every=every),
        use_batch=True, backend_factory=jps.XlaPlanesBackend,
        adaptive_chunk=False, max_batch=128, result_hook=hook)
    calls = _routes(monkeypatch)
    plans = []
    counted_dense = solve_mod.solve_plain

    def planned(params, ps, *a):
        if ps.t >= 100:
            plans.append(solve_mod.plan_batch(ps).kernel)
        return counted_dense(params, ps, *a)

    monkeypatch.setattr(solve_mod, "solve_plain", planned)
    res = perf.run_workload(
        "SchedulingPodAntiAffinity",
        wide_pods_workload(workloads, nodes, init, pods, every=every),
        device="cpu", max_batch=128)
    assert len(res.placements) == init + pods
    assert all(res.placements.values())
    assert res.placements == placed
    assert calls["slots"] == 0 and dense_jax
    assert len(plans) >= pods // 128 and set(plans) == {"wide"}
    colours = {(res.placements[f"pod-{i}"], i % 100)
               for i in range(init, init + pods)}
    assert len(colours) == pods
