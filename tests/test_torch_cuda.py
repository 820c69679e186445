"""The CUDA solve kernel against its plain PyTorch version, on the card,
the backend's lazy solve and scatters on the card against the same calls
on CPU tensors, small GangScheduling, SchedulingPodAntiAffinity and
volume rows through ``run_workload`` on the card against the CPU, and the
shared-volume attach planes on the cluster and one-block kernels.

These tests need an NVIDIA card and nvcc (the kernel has no CPU mode) and
skip without one. This file imports neither JAX nor the kubernetes_tpu
package, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.harness import perf, workloads
from kubernetes_tpu_torch.harness.problems import (
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
def test_past_the_budget_runs_the_one_block_kernel(card):
    args = random_planes(8, 5120, 32, sc=40, t=40, u=2)
    assert solve_mod.solve_kernel.plan(args[0]).kernel == "block"
    want, _, ran = _card_equals_plain(card, args)
    assert ran == "block" and (want >= 0).any()


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
])
def test_slot_kernel_matches_plain(card, seed, n, b, t, sc, u, real):
    args = random_slot_planes(seed, n, b, t, sc=sc, u=u, real=real)
    want, _ = _slots_equal_plain(card, args)
    assert (want >= 0).sum() > b // 2


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
def test_a_pod_of_nine_references_runs_the_one_block_kernel(card):
    ps, state, ints, floats = random_slot_planes(25, 5120, 64, 100)
    ints[3, ps.r + 4 + 2 * ps.sc:ps.r + 4 + 2 * ps.sc + 9] = 1
    assert slot_stream(ints.numpy(), floats.numpy(), ps.r, ps.sc,
                       ps.t) is None
    backend = CudaPlanesBackend(card)
    kernel = solve_mod.solve_kernel
    before = dict(kernel.counts)
    moved = _to(card, ps, state, ints, floats)
    got = backend.solve(SolverParams(), moved[0], moved[1], ints.numpy(),
                        floats.numpy())
    assert kernel.counts == dict(before, block=before["block"] + 1)
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
def test_sv_one_block_kernel_and_carried_state(card):
    """A shared-volume shape past the cluster's shared memory runs the
    one-block kernel; two carried batches on the cluster kernel, one of
    eight, equal the plain version."""
    args = random_planes(44, 5120, 64, r=4, sc=40, t=40, u=2, sv=8)
    assert solve_mod.solve_kernel.plan(args[0]).kernel == "block"
    _, _, ran = _card_equals_plain(card, args)
    assert ran == "block"
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
