"""The CUDA solve kernel against its plain PyTorch version, on the card,
the backend's lazy solve and scatters on the card against the same calls
on CPU tensors, small GangScheduling, SchedulingPodAntiAffinity and
volume rows through ``run_workload`` on the card against the CPU, the
shared-volume attach planes on the cluster and wide kernels, and the
sharded tier's kernels (the sharded solve on its one-cluster route at 1,
2, 4, 8 and 16 shards and on its global route at 3 and 6, the global
route's poll bound, and the feasibility counts) against their plain
versions. The tests
whose names say "one block" hold the shapes the one-block kernel took
before the wide kernel replaced it.

These tests need an NVIDIA card and nvcc (the kernel has no CPU mode) and
skip without one. This file imports neither JAX nor the kubernetes_tpu
package, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import time

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.harness import perf, workloads
from kubernetes_tpu_torch.harness.problems import (
    cache_slot_planes,
    counts_cases,
    random_planes,
    random_slot_planes,
)
from kubernetes_tpu_torch.ops import solve as solve_mod
from kubernetes_tpu_torch.ops.encode import BatchEncoder
from kubernetes_tpu_torch.ops.planes import (
    PStatic,
    prepare,
    state_planes,
    static_planes,
)
from kubernetes_tpu_torch.ops.solve import CudaPlanesBackend
from kubernetes_tpu_torch.ops.slots import slot_stream
from kubernetes_tpu_torch.ops.solver import SolverParams, pack_podin
from kubernetes_tpu_torch.scheduler.snapshot import new_snapshot

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the solve kernel has no CPU mode")
    return torch.device("cuda")


def _problem(seed, n_nodes, n_pods, groups):
    """Seeded nodes over ten zones (one without a zone label) and pods
    mixing hard spread, soft spread, required affinity, anti-affinity and
    preferred weights over ``groups`` label groups."""
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(n_nodes):
        labels = {HOST: f"n{i}"}
        if i != n_nodes - 1:
            labels[ZONE] = f"z{i % 10}"
        nodes.append(Node.from_dict({
            "metadata": {"name": f"n{i}", "labels": labels},
            "status": {"capacity": {"cpu": str(rng.choice([4, 8, 16])),
                                    "memory": "32Gi", "pods": "110"}}}))
    pods = []
    for i in range(n_pods):
        g = f"g{rng.integers(groups)}"
        term = {"labelSelector": {"matchLabels": {"grp": g}}}
        kind = i % 5
        spec = {"containers": [{"name": "c", "resources": {"requests": {
            "cpu": str(rng.choice(["250m", "500m", "1"])),
            "memory": "512Mi"}}}]}
        if kind in (0, 1):
            spec["topologySpreadConstraints"] = [{
                "maxSkew": 1, "topologyKey": ZONE if kind == 0 else HOST,
                "whenUnsatisfiable": ("DoNotSchedule" if kind == 0
                                      else "ScheduleAnyway"),
                "labelSelector": {"matchLabels": {"grp": g}}}]
        elif kind == 2:
            spec["affinity"] = {"podAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    dict(term, topologyKey=ZONE)]}}
        elif kind == 3:
            spec["affinity"] = {"podAntiAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    dict(term, topologyKey=HOST)]}}
        else:
            spec["affinity"] = {"podAffinity": {
                "preferredDuringSchedulingIgnoredDuringExecution": [
                    {"weight": int(rng.integers(1, 10)),
                     "podAffinityTerm": dict(term, topologyKey=ZONE)}]}}
        pods.append(Pod.from_dict({"metadata": {
            "name": f"p{i}", "labels": {"grp": g}}, "spec": spec}))
    enc = BatchEncoder(new_snapshot([], nodes))
    cluster, batch = enc.encode(pods, pad_pods=n_pods + 8)
    ps, state = prepare(cluster, batch, "cpu")
    return ps, state, *(torch.from_numpy(a) for a in pack_podin(batch))


def _to(device, ps, state, ints, floats):
    moved = PStatic(ps.ints.to(device), ps.f32s.to(device),
                    ps.sc_meta.to(device), *ps[3:])
    return moved, state.to(device).clone(), ints.to(device), floats.to(device)


def _card_equals_plain(card, args, plan=None):
    """Solve ``args`` with a kernel on the card (``plan``'s, or the one
    the wrapper plans) and with the plain version on the CPU; assignments
    and final state planes must be equal. Returns (assignments, final
    state, the kernel that ran)."""
    params = SolverParams()
    on_card = _to(card, *args)
    on_cpu = _to("cpu", *args)
    kernel = solve_mod.solve_kernel
    before = dict(kernel.counts)
    if plan is None:
        got = solve_mod.solve(params, *on_card)
    else:
        kernel.check(*on_card)
        got = kernel.launch(params, *on_card, plan)
    torch.cuda.synchronize()
    ran = [k for k in kernel.counts if kernel.counts[k] != before[k]]
    assert len(ran) == 1 and kernel.launches == sum(before.values()) + 1
    want = solve_mod.solve(params, *on_cpu)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    np.testing.assert_array_equal(on_card[1].cpu().numpy(),
                                  on_cpu[1].numpy())
    return want, on_cpu[1], ran[0]


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n_nodes,n_pods,groups", [
    (0, 40, 64, 3), (1, 300, 200, 9), (2, 1000, 256, 16)])
def test_kernel_matches_plain(card, seed, n_nodes, n_pods, groups):
    want, _, ran = _card_equals_plain(
        card, _problem(seed, n_nodes, n_pods, groups))
    assert ran == "cluster"
    assert (want >= 0).any()


@pytest.mark.cuda
def test_ragged_last_slice(card):
    args = random_planes(3, 1408, 96, sc=2, t=2, u=2, real=1400)
    plan = solve_mod.solve_kernel.plan(args[0])
    assert plan.kernel == "cluster"
    assert 1408 - (plan.cluster - 1) * plan.cols_per_block \
        < plan.cols_per_block
    want, _, _ = _card_equals_plain(card, args)
    assert (want >= 0).any()


@pytest.mark.cuda
def test_only_feasible_node_in_the_last_slice(card):
    ps, state, ints, floats = random_planes(4, 5120, 40)
    so, _ = static_planes(ps.r, ps.sc, ps.t, ps.u)
    do, _ = state_planes(ps.r, ps.sc, ps.t)
    only = 5100
    ps.ints[so["masks"]:so["masks"] + ps.u] = 0
    ps.ints[so["masks"]:so["masks"] + ps.u, only] = 1
    ps.ints[so["alloc"]:so["alloc"] + ps.r, only] = 10 ** 7
    ps.ints[so["max_pods"], only] = 1000
    state[do["requested"]:do["pod_count"] + 1, only] = 0
    ints[:, ps.r + 4:] = 0          # no constraints or terms
    want, _, ran = _card_equals_plain(card, (ps, state, ints, floats))
    assert ran == "cluster"
    valid = ints[:, ps.r + 3] > 0
    assert (want[valid] == only).all() and (want[~valid] == -1).all()


@pytest.mark.cuda
def test_ties_across_slice_boundaries(card):
    """Identical nodes: every block offers an equal best score, so the
    lowest index has to win across blocks. The first 330 columns are not
    nodes, so the winners start inside the second slice."""
    ps, state, ints, floats = random_planes(5, 5120, 64)
    so, _ = static_planes(ps.r, ps.sc, ps.t, ps.u)
    for planes in (ps.ints, ps.f32s, state):
        planes[:] = planes[:, :1].clone()
    ps.ints[so["node_valid"], :330] = 0
    ints[:, ps.r + 4:] = 0
    floats[:] = 0
    want, _, _ = _card_equals_plain(card, (ps, state, ints, floats))
    placed = want[ints[:, ps.r + 3] > 0]
    assert (placed >= 330).all()
    assert placed.tolist() == sorted(placed.tolist())   # spread in order


@pytest.mark.cuda
def test_wide_space_at_5k_nodes(card):
    args = random_planes(6, 5120, 128, sc=16, t=16, u=16, real=5000)
    assert solve_mod.solve_kernel.plan(args[0]).kernel == "cluster"
    want, _, ran = _card_equals_plain(card, args)
    assert ran == "cluster" and (want >= 0).sum() > 64


@pytest.mark.cuda
def test_two_batches_carry_state(card):
    ps, state, ints, floats = random_planes(7, 2048, 128, sc=3, t=3, u=2)
    _, carried, _ = _card_equals_plain(card, (ps, state, ints[:64],
                                              floats[:64]))
    want, _, _ = _card_equals_plain(card, (ps, carried, ints[64:].clone(),
                                           floats[64:].clone()))
    assert (want >= 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n,b,sc,t,u,real", [
    (8, 5120, 32, 40, 40, 2, None),
    (50, 1408, 96, 2, 100, 2, 1400),    # a ragged last slice
    (51, 65536, 64, 1, 1, 1, 65000),    # the slices at L2
])
def test_past_the_budget_runs_the_one_block_kernel(card, seed, n, b, sc, t,
                                                   u, real):
    args = random_planes(seed, n, b, sc=sc, t=t, u=u, real=real)
    assert solve_mod.solve_kernel.plan(args[0]).kernel == "wide"
    want, _, ran = _card_equals_plain(card, args)
    assert ran == "wide" and (want >= 0).any()


@pytest.mark.cuda
def test_portable_cluster_of_eight(card):
    """A cluster of 8 at 5,120 columns: some threads own two columns."""
    args = random_planes(9, 5120, 96, sc=2, t=2, u=2)
    plan = solve_mod.plan_launch(5120, 3, 2, 2, 2, max_cluster=8)
    assert plan.kernel == "cluster" and plan.cols_per_block > plan.threads
    _, _, ran = _card_equals_plain(card, args, plan)
    assert ran == "cluster"


def _slots_equal_plain(card, args, plan=None):
    """Solve the slot stream packed from ``args`` with the slot kernel on
    the card (``plan``'s, or the wrapper's slot plan), with
    ``solve_plain_slots`` on the CPU and with the dense ``solve_plain``:
    assignments and final state planes must be equal. Returns the
    assignments and the final state."""
    params = SolverParams()
    ps, state, ints, floats = args
    stream = slot_stream(ints.numpy(), floats.numpy(), ps.r, ps.sc, ps.t)
    assert stream is not None
    sargs = (ps, state, *(torch.from_numpy(a) for a in stream))
    on_card, on_cpu = _to(card, *sargs), _to("cpu", *sargs)
    kernel = solve_mod.solve_kernel
    before = dict(kernel.counts)
    if plan is None:
        got = solve_mod.solve_slots(params, *on_card)
    else:
        kernel.check(*on_card, slots=True)
        got = kernel.launch(params, *on_card, plan)
    torch.cuda.synchronize()
    assert kernel.counts == dict(before, slots=before["slots"] + 1)
    want = solve_mod.solve_plain_slots(params, *on_cpu)
    dense_state = state.clone()
    dense = solve_mod.solve_plain(params, ps, dense_state, ints, floats)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    np.testing.assert_array_equal(on_card[1].cpu().numpy(),
                                  on_cpu[1].numpy())
    np.testing.assert_array_equal(want.numpy(), dense.numpy())
    np.testing.assert_array_equal(on_cpu[1].numpy(), dense_state.numpy())
    return want, on_cpu[1]


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n,b,t,sc,u,real", [
    (20, 5120, 256, 100, 1, 1, 5000),   # the anti-affinity row's shape
    (21, 5120, 128, 50, 2, 2, 5120),
    (22, 1408, 96, 40, 2, 2, 1400),     # a ragged last slice
    (23, 1024, 64, 16, 3, 3, 1000),     # the dense cluster layout fits
    (26, 20480, 128, 100, 1, 1, 20000),  # lines for one pod's terms
])
def test_slot_kernel_matches_plain(card, seed, n, b, t, sc, u, real):
    args = random_slot_planes(seed, n, b, t, sc=sc, u=u, real=real)
    want, _ = _slots_equal_plain(card, args)
    assert (want >= 0).sum() > b // 2


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n,t", [
    (27, 5120, 200),    # terms four times the lines
    (28, 5120, 100),
    (29, 20480, 100),   # eight lines: every window waits for the last
])
def test_slot_kernel_term_line_cache_matches_plain(card, seed, n, t):
    """The stream that works the term-line cache at the plan's chunk
    (``cache_slot_planes``: eight references a pod, two the pod before
    committed, lines evicted and read again three chunks on): the slot
    kernel equals the plain slot solve and the dense plain solve."""
    plan = solve_mod.slots_candidate(n, 3, 1, t, 1)
    lines = solve_mod.slot_cache(3, 1, t, 1, plan.cluster, plan.threads,
                                 plan.cols_per_block, plan.chunk).lines
    assert plan.smem_bytes <= solve_mod.SMEM_LIMIT and lines < t
    args = cache_slot_planes(seed, n, 128, t, plan.chunk, real=n - 100)
    want, _ = _slots_equal_plain(card, args)
    assert (want >= 0).sum() > 32


@pytest.mark.cuda
def test_slot_kernel_carries_state_and_runs_a_cluster_of_eight(card):
    ps, state, ints, floats = random_slot_planes(24, 5120, 128, 100, sc=2,
                                                 u=2)
    _, carried = _slots_equal_plain(card, (ps, state, ints[:64],
                                           floats[:64]))
    plan = solve_mod.slots_candidate(5120, ps.r, ps.sc, ps.t, ps.u,
                                     max_cluster=8)
    assert plan.cluster == 8 and plan.cols_per_block > plan.threads
    want, _ = _slots_equal_plain(card, (ps, carried, ints[64:].clone(),
                                        floats[64:].clone()), plan)
    assert (want >= 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n,real", [
    (25, 5120, None),
    (52, 1408, 1400),       # a ragged last slice
    (53, 65536, 65000),     # the slices at L2
])
def test_a_pod_of_nine_references_runs_the_one_block_kernel(card, seed, n,
                                                            real):
    ps, state, ints, floats = random_slot_planes(seed, n, 64, 100,
                                                 real=real)
    ints[3, ps.r + 4 + 2 * ps.sc:ps.r + 4 + 2 * ps.sc + 9] = 1
    assert slot_stream(ints.numpy(), floats.numpy(), ps.r, ps.sc,
                       ps.t) is None
    backend = CudaPlanesBackend(card)
    kernel = solve_mod.solve_kernel
    before = dict(kernel.counts)
    moved = _to(card, ps, state, ints, floats)
    got = backend.solve(SolverParams(), moved[0], moved[1], ints.numpy(),
                        floats.numpy())
    assert kernel.counts == dict(before, wide=before["wide"] + 1)
    want = solve_mod.solve_plain(SolverParams(), ps, state, ints, floats)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(moved[1].cpu().numpy(), state.numpy())


@pytest.mark.cuda
def test_backend_takes_the_slot_kernel_lazily(card):
    """The backend packs a T = 100 batch into slots and launches the slot
    kernel without waiting; two chained batches equal the CPU backend."""
    params = SolverParams()
    ps, state, ints, floats = random_slot_planes(26, 5120, 256, 100)
    cpu_state = state.clone()
    moved = _to(card, ps, state, ints, floats)
    backend = CudaPlanesBackend(card)
    kernel = solve_mod.solve_kernel
    before = kernel.counts["slots"]
    handles = [backend.solve_lazy(params, moved[0], moved[1],
                                  ints[lo:lo + 128].numpy(),
                                  floats[lo:lo + 128].numpy())
               for lo in (0, 128)]
    got = np.concatenate([backend.materialize(h) for h in handles])
    assert kernel.counts["slots"] == before + 2
    cpu = CudaPlanesBackend(torch.device("cpu"))
    want = np.concatenate([cpu.solve(params, ps, cpu_state,
                                     ints[lo:lo + 128].numpy(),
                                     floats[lo:lo + 128].numpy())
                           for lo in (0, 128)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(moved[1].cpu().numpy(), cpu_state.numpy())


def _backend_args(device, seed, n, b, **kw):
    ps, state, ints, floats = random_planes(seed, n, b, **kw)
    moved = _to(device, ps, state, ints, floats)
    return moved[0], moved[1], ints.numpy(), floats.numpy()


@pytest.mark.cuda
def test_solve_lazy_returns_before_the_kernel_ends(card):
    """At 5,120 columns and 4,096 pods the kernel runs for milliseconds;
    the dispatch does not wait for it, and the materialized assignments
    equal an eager solve of the same inputs."""
    backend = CudaPlanesBackend(card)
    ps, state, ints, floats = _backend_args(card, 10, 5120, 4096)
    eager_state = state.clone()
    torch.cuda.synchronize()
    handle = backend.solve_lazy(SolverParams(), ps, state, ints, floats)
    assert not handle.event.query()
    got = backend.materialize(handle)
    assert handle.event.query()
    want = backend.solve(SolverParams(), ps, eager_state, ints, floats)
    np.testing.assert_array_equal(got, want)
    assert torch.equal(state, eager_state)
    assert (got >= 0).sum() > 1000


@pytest.mark.cuda
def test_chained_lazy_solves_equal_eager_ones_and_the_cpu(card):
    params = SolverParams()
    backend = CudaPlanesBackend(card)
    ps, state, ints, floats = _backend_args(card, 11, 2048, 256, sc=2, t=2,
                                            u=2)
    eager = state.clone()
    first = backend.solve_lazy(params, ps, state, ints[:128], floats[:128])
    second = backend.solve_lazy(params, ps, state, ints[128:], floats[128:])
    got = np.concatenate([backend.materialize(first),
                          backend.materialize(second)])
    want = np.concatenate([
        backend.solve(params, ps, eager, ints[:128], floats[:128]),
        backend.solve(params, ps, eager, ints[128:], floats[128:])])
    np.testing.assert_array_equal(got, want)
    assert torch.equal(state, eager)
    cpu = CudaPlanesBackend(torch.device("cpu"))
    cps, cstate, _, _ = _backend_args("cpu", 11, 2048, 256, sc=2, t=2, u=2)
    plain = np.concatenate([
        cpu.solve(params, cps, cstate, ints[:128], floats[:128]),
        cpu.solve(params, cps, cstate, ints[128:], floats[128:])])
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(state.cpu().numpy(), cstate.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_scatters_on_the_card_equal_the_cpu(card, seed):
    """Adds with duplicate targets and (0, 0, 0) pads; sets with distinct
    targets padded by repeating the last entry."""
    rng = np.random.default_rng(seed)
    ps, state, _, _ = random_planes(seed, 1024, 8, sc=2, t=2, u=2)
    dev = _to(card, ps, state, torch.zeros(1), torch.zeros(1))
    m = int(rng.integers(20, 200))
    rows = rng.integers(0, state.shape[0], m).astype(np.int32)
    cols = rng.integers(0, 1024, m).astype(np.int32)
    vals = rng.integers(-1000, 1000, m).astype(np.int32)
    rows[m // 2:m // 2 + 5], cols[m // 2:m // 2 + 5] = rows[0], cols[0]
    pad = 256 - m
    add = [np.concatenate([a, np.zeros(pad, np.int32)])
           for a in (rows, cols, vals)]
    flat = rng.choice(ps.ints.shape[0] * 1024, m, replace=False)
    sets = [(flat // 1024).astype(np.int32), (flat % 1024).astype(np.int32),
            rng.integers(0, 10 ** 6, m).astype(np.int32)]
    sets = [np.concatenate([a, np.full(pad, a[-1], np.int32)]) for a in sets]
    on_card = CudaPlanesBackend(card)
    on_cpu = CudaPlanesBackend(torch.device("cpu"))
    assert on_card.scatter_state_add(dev[1], *add) == \
        on_cpu.scatter_state_add(state, *add) == 256 * 12
    on_card.scatter_static_set(dev[0], *sets)
    on_cpu.scatter_static_set(ps, *sets)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(dev[1].cpu().numpy(), state.numpy())
    np.testing.assert_array_equal(dev[0].ints.cpu().numpy(),
                                  ps.ints.numpy())
    assert on_card.scatters == {"add": 1, "set": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n,b,sv,sc,t,u,real", [
    (40, 1024, 256, 8, 2, 2, 2, 1000),
    (41, 5120, 256, 64, 1, 1, 1, 5000),
    (42, 1024, 1024, 512, 1, 1, 1, 1000),   # the shared-volume phase's SV
    (43, 1408, 96, 8, 3, 2, 2, 1400),       # a ragged last slice
])
def test_sv_cluster_kernel_matches_plain(card, seed, n, b, sv, sc, t, u,
                                         real):
    args = random_planes(seed, n, b, r=4, sc=sc, t=t, u=u, real=real, sv=sv)
    want, _, ran = _card_equals_plain(card, args)
    assert ran == "cluster" and (want >= 0).sum() > b // 4


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n,sc,t,u,real,sv", [
    (44, 5120, 40, 40, 2, None, 8),
    (54, 1408, 2, 100, 2, 1400, 16),    # a ragged last slice
    (55, 65536, 1, 1, 1, 65000, 8),     # the slices at L2
])
def test_sv_one_block_kernel_and_carried_state(card, seed, n, sc, t, u,
                                               real, sv):
    """A shared-volume shape past the cluster's shared memory runs the
    wide kernel; two carried batches on the cluster kernel, one of
    eight, equal the plain version."""
    args = random_planes(seed, n, 64, r=4, sc=sc, t=t, u=u, real=real,
                         sv=sv)
    assert solve_mod.solve_kernel.plan(args[0]).kernel == "wide"
    _, _, ran = _card_equals_plain(card, args)
    assert ran == "wide"
    ps, state, ints, floats = random_planes(45, 5120, 192, r=4, sc=2, t=2,
                                            u=2, sv=16)
    _, carried, _ = _card_equals_plain(card, (ps, state, ints[:96],
                                              floats[:96]))
    plan = solve_mod.plan_launch(5120, 4, 2, 2, 2, max_cluster=8, sv=16)
    assert plan.kernel == "cluster" and plan.cluster == 8
    want, _, ran = _card_equals_plain(card, (ps, carried, ints[96:].clone(),
                                             floats[96:].clone()), plan)
    assert ran == "cluster" and (want >= 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("name,nodes,init,pods,kernel", [
    ("GangScheduling", 100, 0, 600, "cluster"),
    ("SchedulingPodAntiAffinity", 3000, 0, 300, "slots"),
    ("SchedulingCSIPVs", 100, 20, 400, "cluster"),
    ("SchedulingSharedPVs", 100, 0, 300, "cluster"),
])
def test_small_rows_on_the_card_equal_the_cpu(card, name, nodes, init, pods,
                                              kernel):
    """The gang row (hard zone spread: the cluster kernel) and the
    anti-affinity row (T = 100 over 3,000 nodes, past the cluster's dense
    layout, one term a pod: the slot kernel) bind every pod to the same
    node on the card as on the CPU, and the card ran the kernel the
    launch plan picks."""
    kernel_fn = solve_mod.solve_kernel
    kernel_fn.reset_counts()
    on_card = perf.run_workload(
        name, workloads.make_workload(name, nodes, init, pods),
        max_batch=128, device="cuda")
    counts = dict(kernel_fn.counts)
    on_cpu = perf.run_workload(
        name, workloads.make_workload(name, nodes, init, pods),
        max_batch=128, device="cpu")
    assert all(on_card.placements.values())
    assert on_card.placements == on_cpu.placements
    assert counts[kernel] == on_card.solves > 0


@pytest.mark.cuda
def test_devprof_device_time_within_events_of_its_own(card):
    """A synchronous solve after a row, timed by an event pair of the
    test's own around the whole call (uploads, launch, readback):
    devprof's ``device_s`` for its cycle (the backend's pair around the
    launch alone) is positive and at most that time. The row's telemetry
    carries its measured cycles' sum, and every cycle has device time."""
    from kubernetes_tpu_torch.observability.devprof import get_devprof

    held = {}
    ops = workloads.make_workload("SchedulingBasic", 200, 0, 1000)
    res = perf.run_workload("SchedulingBasic", ops, max_batch=128,
                            device="cuda",
                            configure=lambda bs: held.update(bs=bs))
    dp = get_devprof()
    assert all(c["device_s"] > 0 for c in dp.cycles(include_warming=True))
    measured = sum(c["device_s"] for c in dp.cycles())
    assert res.telemetry["device_s"] == pytest.approx(measured, abs=1e-6)
    assert res.telemetry["d2h_bytes"] > 0 and res.telemetry["h2d_bytes"] > 0
    (op,) = [o for o in ops if o.get("collectMetrics")]
    pods = [Pod.from_dict(op["podTemplate"](5000 + i)) for i in range(100)]
    session = held["bs"].session
    before = len(dp.cycles())
    torch.cuda.synchronize()
    started = torch.cuda.Event(enable_timing=True)
    ended = torch.cuda.Event(enable_timing=True)
    started.record()
    session.solve(pods, 128)
    ended.record()
    ended.synchronize()
    outer_s = started.elapsed_time(ended) / 1000.0
    cycles = dp.cycles()
    assert len(cycles) == before + 1
    assert 0 < cycles[-1]["device_s"] <= outer_s


@pytest.mark.cuda
def test_a_warmed_pad_triggers_no_first_load(card):
    """With every kernel instance counted as not yet launched, a row
    whose budget is cut after its warm-up books each first launch to a
    warm-up (the warm-up's solves, or a pad warm between cycles), never
    to a measured cycle, while its pad steps down to 512. With the pinned
    staging ring emptied too, the warm-up books its allocations, and no
    smaller pad allocates after it."""
    kernel = solve_mod.solve_kernel
    kernel.launched.clear()
    solve_mod.STAGING.clear()
    warms, allocated = [], []

    def configure(bs):
        warmup, warm_pad = bs.warmup, bs.session.warm_pad

        def cut_after_warmup(samples):
            out = warmup(samples)
            bs.LATENCY_BUDGET_S = 1e-6
            allocated.append(len(solve_mod.STAGING.allocations))
            return out

        def warm_pad_at(pods, pad):
            got = warm_pad(pods, pad)
            warms.append((pad, got))
            return got

        bs.warmup, bs.session.warm_pad = cut_after_warmup, warm_pad_at

    res = perf.run_workload(
        "SchedulingBasic", workloads.make_workload("SchedulingBasic", 200, 0,
                                                   6000),
        max_batch=2048, device="cuda", configure=configure)
    assert all(res.placements.values())
    assert res.chunk == 512 and 512 in [pad for pad, _ in warms]
    assert all(got is not None for _, got in warms), warms
    assert allocated[0] >= 2   # the upload and readback capacities
    assert len(solve_mod.STAGING.allocations) == allocated[0]
    assert kernel.launched and res.telemetry["warm_compiles"] >= 1
    assert res.telemetry["unexpected_compiles"] == 0
    assert res.telemetry["compiles"] == 0


# ----------------------------------------------------------------------
# the legacy scan (the cluster autoscaler's what-if)
@pytest.mark.cuda
@pytest.mark.parametrize("seed,host_key,n_pods", [
    (0, True, 200), (1, False, 200), (2, True, 600)])
def test_scan_kernel_matches_plain(card, seed, host_key, n_pods):
    """``solve_scan_kernel`` against the plain scan on seeded what-ifs
    (zone and hostname keys, hard and soft spread, (anti-)affinity,
    preferred weights, graded penalty tiers, disabled columns, padded
    rows): the assignments and every final table equal."""
    from kubernetes_tpu_torch.harness.problems import whatif_problem
    from kubernetes_tpu_torch.ops import solver

    cluster, batch, pen, dis = whatif_problem(seed, host_key=host_key,
                                              n_pods=n_pods, pad=1024)
    scores, valid = solver.whatif_overrides(cluster, batch, pen, dis)
    outs = []
    before = solver.scan_kernel.launches
    for device in (card, torch.device("cpu")):
        static, state, ints, floats = solver.scan_inputs(
            cluster, batch, device, scores, valid)
        a = solver.solve_packed(SolverParams(), static, state, ints, floats)
        outs.append([a.cpu()] + [t.cpu() for t in state])
    assert solver.scan_kernel.launches == before + 1
    for x, y in zip(*outs):
        assert torch.equal(x, y)
    assert (outs[0][0] >= 0).any()


def _scan_run(kernel_or_plain, static, state, ints, floats, **plan):
    st = type(state)(*(t.clone() for t in state))
    if kernel_or_plain is None:
        from kubernetes_tpu_torch.ops import solver
        got = solver.solve_scan_plain(SolverParams(), static, st, ints,
                                      floats)
    else:
        got = kernel_or_plain(SolverParams(), static, st, ints, floats,
                              **plan)
    return [got.cpu(), *(t.cpu() for t in st)]


@pytest.mark.cuda
def test_scan_kernel_cases_match_plain_and_repeat(card):
    """The redesigned kernel on ``scan_cases`` (N at each k boundary,
    zone keys, hard spread only, terms only, tables and column arrays
    forced to global memory, B = 37, all padding, B = 0): three launches
    on fresh copies of the state give the same assignments and state,
    equal bit for bit to the plain scan on CPU copies."""
    from kubernetes_tpu_torch.harness.problems import (
        scan_case_inputs,
        scan_cases,
    )
    from kubernetes_tpu_torch.ops import solver

    for case in scan_cases(seed=11, n_pods=160):
        static, state, ints, floats = scan_case_inputs(case, card)
        cpu = scan_case_inputs(case, "cpu")
        want = _scan_run(None, *cpu)
        for _ in range(3):
            got = _scan_run(solver.scan_kernel, static, state, ints, floats,
                            **case.plan)
            for x, y in zip(got, want):
                assert torch.equal(x, y), case.name


@pytest.mark.cuda
@pytest.mark.parametrize("cut", [False, True],
                         ids=["as-encoded", "real-columns"])
def test_scan_kernel_on_the_federations_tiny_column_counts(card, cut):
    """The federation's what-ifs (``federation_cases``: one column per
    cluster, N = 128 as encoded or cut to the 1-3 real columns): one
    column enabled, every column disabled (every unit unplaced), a column
    with both the remote and the saturation penalty. Three launches
    alike, equal to the plain scan; as encoded, ``solve_whatif`` on the
    card equals the numpy oracle."""
    from kubernetes_tpu_torch.autoscaler.simulator import _serial_whatif
    from kubernetes_tpu_torch.harness.problems import (
        ScanCase,
        federation_cases,
        scan_case_inputs,
    )
    from kubernetes_tpu_torch.ops import solver

    for name, problem, cols in federation_cases(seed=4):
        case = ScanCase(name, problem, n=cols if cut else None)
        static, state, ints, floats = scan_case_inputs(case, card)
        want = _scan_run(None, *scan_case_inputs(case, "cpu"))
        for _ in range(3):
            got = _scan_run(solver.scan_kernel, static, state, ints, floats)
            for x, y in zip(got, want):
                assert torch.equal(x, y), name
        if "all disabled" in name:
            assert bool((want[0] == -1).all())
        if not cut:
            cluster, batch, pen, dis = problem
            before = solver.scan_kernel.launches
            a, _ = solver.solve_whatif(cluster, batch, deprioritized_cols=pen,
                                       disabled_cols=dis, device=card)
            assert solver.scan_kernel.launches == before + 1
            oracle, _ = _serial_whatif(cluster, batch, SolverParams(),
                                       deprioritized_cols=pen,
                                       disabled_cols=dis)
            assert np.array_equal(a, oracle), name


@pytest.mark.cuda
def test_federation_scheduler_on_the_card_places_like_the_oracle(card):
    """The same placements through ``FederationScheduler`` with the scan
    kernel deciding (one launch a solve) and with the numpy oracle."""
    from kubernetes_tpu_torch import federation as fed
    from kubernetes_tpu_torch.ops import solver

    def place(serial):
        ledger = fed.CapacityLedger()
        for cid, milli in enumerate((16000, 16000, 6000)):
            ledger.register(cid)
            ledger.refresh_from(cid, [Node.from_dict({
                "metadata": {"name": f"c{cid}-node-0"},
                "status": {"capacity": {"cpu": f"{milli}m",
                                        "memory": "64Gi",
                                        "pods": "110"}}})], [])
        ledger.note_admitted(1, [Pod.from_dict({
            "metadata": {"name": "fat", "uid": "fat"},
            "spec": {"containers": [{"name": "c", "resources": {
                "requests": {"cpu": "14"}}}]}})])
        sched = fed.FederationScheduler(
            ledger, policy=fed.FederationPolicy(serial=serial),
            home_of=lambda ns: {"a": 0, "b": 1}.get(ns), device=card)
        pods = [Pod.from_dict({
            "metadata": {"name": f"p{i}", "uid": f"u{i}",
                         "namespace": "abc"[i % 3], "labels": (
                             {fed.GANG_NAME_LABEL: f"g{i // 4}"}
                             if i % 8 < 4 else {})},
            "spec": {"containers": [{"name": "c", "resources": {
                "requests": {"cpu": "900m"}}}]}}) for i in range(40)]
        before = solver.scan_kernel.launches
        out = [(pl.unit.namespace, pl.cluster) for pl in sched.place(pods)]
        return out, sched.solves, solver.scan_kernel.launches - before

    got, solves, launches = place(False)
    want, _, oracle_launches = place(True)
    assert got == want
    assert launches == solves > 0 and oracle_launches == 0


@pytest.mark.cuda
def test_scan_kernel_layout_agrees_and_refuses_a_wrong_byte_count(card):
    """The C side's layout bytes equal ``scan_smem_words`` over plan
    shapes; a launch whose byte count disagrees is refused."""
    from kubernetes_tpu_torch.harness.problems import whatif_problem
    from kubernetes_tpu_torch.ops import solver

    lib = solver.scan_kernel._load()
    for n in (1, 31, 512, 1025, 1536, 5400):
        for tables in (True, False):
            for cols in (True, False):
                try:
                    plan = solver.scan_plan(3, 2, 3, n, n, 64, tables=tables,
                                            cols=cols)
                except ValueError:   # no chunk fits this placement
                    continue
                assert lib.ktt_scan_smem_bytes(
                    3, 2, 3, n, n, plan.k, plan.threads, plan.chunk,
                    int(tables), int(cols)) == plan.smem_bytes
    cluster, batch, pen, dis = whatif_problem(0, n_pods=20, pad=32)
    static, state, ints, floats = solver.scan_inputs(cluster, batch, card)
    plan = solver.scan_kernel.plan(static, ints.shape[0])
    bad = plan._replace(smem_bytes=plan.smem_bytes + 4)
    with pytest.raises(RuntimeError, match="launch failed"):
        solver.scan_kernel.launch(SolverParams(), static, state, ints,
                                  floats, bad)


# ----------------------------------------------------------------------
# the sharded tier
def _sharded_on(device, ss, st):
    from kubernetes_tpu_torch.parallel import SState

    return (ss._replace(sc_meta=ss.sc_meta.to(device),
                        ints=ss.ints.to(device), f32s=ss.f32s.to(device),
                        has_dom=ss.has_dom.to(device)),
            SState(st.planes.to(device).clone(), st.totals.to(device).clone()))


SHARDED_SEEDS = [
    (40, dict(sc=2, t=3, u=2)),                  # hard spread, as drawn
    (41, dict(sc=2, t=2, u=2, hard=False)),      # no hard constraint
    (42, dict(r=4, sc=2, t=2, u=2, sv=16)),      # shared-volume slots
    (43, dict(sc=1, t=40, u=2))]                 # a wide term axis


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("seed,kw", SHARDED_SEEDS)
def test_sharded_kernel_matches_plain(card, shards, seed, kw):
    """``solve_sharded_kernel`` on its one-cluster route (every shard a
    block group of one cluster) against ``solve_sharded_plain`` (CPU) and
    the single-card plain solve: assignments, planes and each shard's
    totals; the feasibility counts kernel against its plain version on
    a 2 x ``shards`` mesh."""
    _sharded_equals_plain(card, shards, seed, kw, 1024, one_cluster=True)


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [3, 6])
@pytest.mark.parametrize("seed,kw", SHARDED_SEEDS)
def test_sharded_kernel_global_route_matches_plain(card, shards, seed, kw):
    """The same on the global route: a mesh whose shard count divides no
    cluster size runs a cluster a shard, exchanging through global
    memory."""
    _sharded_equals_plain(card, shards, seed, kw, 1536, one_cluster=False)


def _sharded_equals_plain(card, shards, seed, kw, n, one_cluster):
    from kubernetes_tpu_torch.parallel import sharded

    kw = dict(kw)
    hard = kw.pop("hard", True)
    ps, state, ints, floats = random_planes(seed, n, 256, **kw)
    ps.sc_meta[1] = 1 if hard else 0
    ss, st = sharded.shard_planes(ps, state, shards)
    ssc, stc = _sharded_on(card, ss, st)
    params = SolverParams()
    kernel = solve_mod.solve_kernel
    plan = kernel.sharded_plan(ssc, shards)
    assert (solve_mod.sharded_groups(plan, shards, n) > 0) == one_cluster
    before = kernel.counts["sharded"]
    got, err = kernel.launch_sharded(params, ssc, stc.planes, stc.totals,
                                     ints.to(card), floats.to(card))
    torch.cuda.synchronize()
    assert int(err[0]) == 0 and kernel.counts["sharded"] == before + 1
    want = sharded.solve_sharded_plain(params, ss, st, ints, floats)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert torch.equal(stc.planes.cpu(), st.planes)
    assert torch.equal(stc.totals.cpu(), st.totals)
    single = state.clone()
    assert torch.equal(solve_mod.solve_plain(params, ps, single, ints,
                                             floats), want)
    do, _ = state_planes(ps.r, ps.sc, ps.t, ps.sv)
    assert all(torch.equal(st.totals[s], single[do["totals"], :ps.t])
               for s in range(shards))
    counts = kernel.launch_counts(ssc, ints.to(card), shards, 2)
    np.testing.assert_array_equal(
        counts.cpu().numpy(),
        sharded.feasible_counts_plain(ss, ints, shards, 2).numpy())
    assert (want >= 0).sum() > 0


COUNTS_CASES = ["counts-ragged-4002", "counts-one-pod", "counts-128",
                "counts-65536", "counts-three-profiles",
                "counts-no-valid-node", "counts-fit-nowhere", "counts-r1",
                "counts-r6", "counts-chunks-81920"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", COUNTS_CASES)
def test_counts_kernel_matches_plain(card, name):
    """The feasibility counts kernel's bare launch (the profiles checked
    here first) equals its plain version bit for bit on each of
    ``counts_cases`` at every mesh it lists, one launch a call, writing
    every count over a buffer it did not zero."""
    from kubernetes_tpu_torch.parallel import sharded

    [(ps, ints, widths, axes)] = [c[1:] for c in counts_cases()
                                  if c[0] == name]
    solve_mod.check_profiles(ints[:, ps.r + 2], ps.u)
    psc = type(ps)(ps.ints.to(card), ps.f32s.to(card), ps.sc_meta.to(card),
                   *ps[3:])
    ints_c = ints.to(card)
    kernel = solve_mod.solve_kernel
    for shards in widths:
        for axis in axes:
            junk = torch.full((ints.shape[0],), -7, dtype=torch.int32,
                              device=card)
            # freed to the caching allocator, whose next block of this
            # size the wrapper's uninitialised counts take
            del junk
            before = kernel.counts["counts"]
            got = kernel.launch_counts(psc, ints_c, shards, axis,
                                       profiles=False)
            assert kernel.counts["counts"] == before + 1
            np.testing.assert_array_equal(
                got.cpu().numpy(),
                sharded.feasible_counts_plain(ps, ints, shards,
                                              axis).numpy())


@pytest.mark.cuda
def test_sharded_launch_refuses_clusters_that_cannot_coreside(card):
    """16 shards of 16 blocks on the global route (the plan's cut of one
    shard's columns, which no one cluster holds 16 times), each block of
    512 threads over more than half an SM's shared memory, are more
    blocks than the card's 132 SMs hold at once: the launch raises
    instead of spinning."""
    from kubernetes_tpu_torch.parallel import sharded

    ps, state, ints, floats = random_planes(44, 16 * 8192, 8, u=25)
    ss, st = _sharded_on(card, *sharded.shard_planes(ps, state, 16))
    plan = solve_mod.wide_candidate(8192, ps.r, ps.sc, ps.t, ps.u,
                                    max_cluster=16, kernel="sharded")
    assert plan.cluster == 16 and plan.threads == 512
    assert plan.smem_bytes > solve_mod.SMEM_LIMIT // 2
    with pytest.raises(RuntimeError, match="launch failed"):
        solve_mod.solve_kernel.launch_sharded(
            SolverParams(), ss, st.planes, st.totals, ints.to(card),
            floats.to(card), plan=plan)


@pytest.mark.cuda
def test_sharded_error_word_raises(card):
    """On the global route (three shards), a batch with a hard spread
    constraint launched on the instance without the round of domain
    minima (``any_hard`` False) sets the exchange's error word; the
    wrapper raises on it."""
    from kubernetes_tpu_torch.parallel import sharded

    ps, state, ints, floats = random_planes(45, 1536, 64, sc=2, t=2, u=2)
    ps.sc_meta[1] = 1
    ints[:, ps.r + 4:ps.r + 4 + ps.sc] = 1
    ss, st = _sharded_on(card, *sharded.shard_planes(ps, state, 3))
    ss = ss._replace(any_hard=False)
    plan = solve_mod.solve_kernel.sharded_plan(ss, 3)
    assert solve_mod.sharded_groups(plan, 3, 1536) == 0
    with pytest.raises(RuntimeError, match="hard spread"):
        sharded.solve_sharded(SolverParams(), ss, st, ints.to(card),
                              floats.to(card))


@pytest.mark.cuda
def test_sharded_poll_runs_out_and_the_card_stays_usable(card, monkeypatch):
    """A launch on the global route (three shards) with the last shard's
    cluster left out of the grid: the first poll for its flag runs out
    after its bound, sets the error word, and every later poll gives up
    at once, so the launch ends and the wrapper raises; a whole launch
    after it equals the plain version."""
    from kubernetes_tpu_torch.parallel import sharded

    ps, state, ints, floats = random_planes(46, 1536, 64, sc=2, t=2, u=2)
    ps.sc_meta[1] = 0
    ss, st = sharded.shard_planes(ps, state, 3)
    kernel = solve_mod.solve_kernel
    lib = kernel._load()

    class OneShort:
        def __getattr__(self, name):
            return getattr(lib, name)

    short = OneShort()
    short.ktt_solve_sharded_launch = lib.ktt_solve_sharded_launch_one_short
    ssc, stc = _sharded_on(card, ss, st)
    with monkeypatch.context() as m:
        m.setattr(kernel, "_load", lambda: short)
        t0 = time.monotonic()
        _, err = kernel.launch_sharded(SolverParams(), ssc, stc.planes,
                                       stc.totals, ints.to(card),
                                       floats.to(card))
        torch.cuda.synchronize()
        took = time.monotonic() - t0
    with pytest.raises(RuntimeError, match="ran out"):
        solve_mod.check_exchange(int(err[0]))
    assert 2.0 <= took < 30.0
    ssc, stc = _sharded_on(card, ss, st)
    got, err = kernel.launch_sharded(SolverParams(), ssc, stc.planes,
                                     stc.totals, ints.to(card),
                                     floats.to(card))
    torch.cuda.synchronize()
    assert int(err[0]) == 0
    want = sharded.solve_sharded_plain(SolverParams(), ss, st, ints, floats)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
