"""The port's sharded tier (``kubernetes_tpu_torch/parallel``) against the
JAX package's mesh tier on the 8 virtual CPU devices ``conftest.py``
forces: the same encoded batches give the same assignments and feasible
counts as the JAX ``solve_scan_sharded`` and ``solve_scan``, and the same
final planes and totals through both packages' ``ShardedBackend.solve``,
at mesh widths 1, 2, 4 and the reference tests' (8, batch_axis 2) and
(8, batch_axis 1); the port's single-card planes equal every row but the
totals row, which the sharded scan leaves as it found it (its totals
live in ``SState.totals``, one copy a shard). Also: shared-volume slots,
a wide term axis, the encoder's node-column split, the workload level
through the sidecar (against the port's batch path and the JAX sharded
arm), the mirror on against off on the sharded tier, and the tiering
guards of ``ops/session.py::default_backend``."""

import copy
import random

import numpy as np
import pytest
import torch

from kubernetes_tpu.api.types import Node as JaxNode, Pod as JaxPod
from kubernetes_tpu.apiserver.store import ClusterStore as JaxStore
from kubernetes_tpu.config.feature_gates import FeatureGates
from kubernetes_tpu.config.types import KubeSchedulerConfiguration
from kubernetes_tpu.ops import solve_scan as jax_solve_scan
from kubernetes_tpu.ops.solver import SolverParams as JaxParams
from kubernetes_tpu.ops.solver import pack_podin as jax_pack_podin
from kubernetes_tpu.parallel import ShardedBackend as JaxShardedBackend
from kubernetes_tpu.parallel import make_mesh as jax_make_mesh
from kubernetes_tpu.parallel import solve_scan_sharded as jax_sharded
from kubernetes_tpu.scheduler.scheduler import Scheduler as JaxScheduler
from kubernetes_tpu.sidecar import attach_batch_scheduler
from kubernetes_tpu_torch import parallel
from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.ops import session as session_mod
from kubernetes_tpu_torch.ops.encode import BatchEncoder
from kubernetes_tpu_torch.ops.planes import prepare, state_planes
from kubernetes_tpu_torch.ops import solve as solve_mod
from kubernetes_tpu_torch.ops.solve import CudaPlanesBackend, solve_plain
from kubernetes_tpu_torch.ops.solver import SolverParams, pack_podin
from kubernetes_tpu_torch.parallel import (
    ShardedBackend,
    make_mesh,
    solve_scan_sharded,
)
from kubernetes_tpu_torch.scheduler.scheduler import Scheduler
from kubernetes_tpu_torch.scheduler.snapshot import new_snapshot
from kubernetes_tpu_torch.sidecar import BatchScheduler
from test_torch_cases import mixed_cluster, wide_pods
from test_torch_encode import encoders
from test_torch_mirror import _scenario
from test_torch_pipeline import _port_set_cpu, pump
from test_torch_volumes import Twin, claim, node_dict, pod_dict

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
PARAMS = SolverParams()

# (shards, batch axis): the widths of this slice and the reference tests'
MESHES = [(1, 1), (2, 1), (4, 1), (8, 2), (8, 1)]


def _node(name, cpu, memory, **labels):
    return {"metadata": {"name": name, "labels": {HOST: name, **labels}},
            "status": {"capacity": {"cpu": cpu, "memory": memory,
                                    "pods": "110"}}}


def _pod(name, cpu, labels=None, **spec):
    return {"metadata": {"name": name, "uid": f"u-{name}",
                         "labels": dict(labels or {})},
            "spec": {"containers": [{"name": "c", "resources": {
                "requests": {"cpu": cpu}}}], **spec}}


def basic_fit():
    """``tests/test_sharded.py``'s first case: 30 pods of 2 cpu on 20
    nodes of 4."""
    nodes = [_node(f"n{i}", "4", "8Gi") for i in range(20)]
    pods = [_pod(f"p{i}", "2") for i in range(30)]
    return nodes, [], pods


def spread_and_affinity():
    """Its second: a hard zone spread on every third pod, a hostname
    anti-affinity on the next."""
    nodes = [_node(f"n{i}", "16", "32Gi", **{ZONE: f"z{i % 4}"})
             for i in range(16)]
    pods = []
    for i in range(24):
        spec = {}
        if i % 3 == 0:
            spec["topologySpreadConstraints"] = [{
                "maxSkew": 1, "topologyKey": ZONE,
                "whenUnsatisfiable": "DoNotSchedule",
                "labelSelector": {"matchLabels": {"app": "w"}}}]
        elif i % 3 == 1:
            spec["affinity"] = {"podAntiAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [{
                    "labelSelector": {"matchExpressions": [{
                        "key": "app", "operator": "In", "values": ["w"]}]},
                    "topologyKey": HOST}]}}
        pods.append(_pod(f"p{i}", "1", {"app": "w"}, **spec))
    return nodes, [], pods


def wide_terms():
    """A term axis of at least twelve (``test_torch_cases.wide_pods``)."""
    nodes, existing = mixed_cluster()
    return nodes, existing, wide_pods()


CASES = {"basic_fit": basic_fit, "spread_and_affinity": spread_and_affinity,
         "wide_terms": wide_terms}


def _encode(case, pad_pods=32):
    nodes, existing, pods = CASES[case]()
    port, ref = encoders(nodes, existing)
    got = port.encode([Pod.from_dict(p) for p in pods], pad_pods=pad_pods)
    want = ref.encode([JaxPod.from_dict(p) for p in pods], pad_pods=pad_pods)
    return got + want


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_scan_sharded_matches_the_reference(case):
    """Assignments and feasible counts at every mesh width equal the JAX
    sharded solve's and its single-device scan's."""
    got_c, got_b, ref_c, ref_b = _encode(case)
    if case == "wide_terms":
        assert ref_b.term_counts.shape[0] >= 12
    single = np.asarray(jax_solve_scan(ref_c, ref_b))
    for shards, batch_axis in MESHES:
        want, want_counts = jax_sharded(
            ref_c, ref_b, jax_make_mesh(shards, batch_axis=batch_axis))
        got, counts = solve_scan_sharded(
            got_c, got_b, make_mesh(shards, batch_axis, device="cpu"))
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(got, single)
        np.testing.assert_array_equal(counts, np.asarray(want_counts))
    real = got_b.num_real_pods
    assert (got[:real] >= 0).sum() > real // 2
    if case == "basic_fit":
        assert all(counts[:real] > 0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_backend_state_matches_the_reference_and_the_single_card(case):
    """The final planes and totals through both packages' backends, two
    batches carrying the state; against the single-card plain solve every
    row but the planes' totals row, and each shard's totals against that
    row's first T columns."""
    got_c, got_b, ref_c, ref_b = _encode(case)
    ints, floats = pack_podin(got_b)
    jints, jfloats = jax_pack_podin(ref_b)
    halves = []
    for lo, hi in ((0, 16), (16, 32)):
        mask = np.zeros(len(ints), dtype=bool)
        mask[lo:hi] = True
        halves.append(tuple(np.where(mask[:, None], a, 0)
                            for a in (ints, floats, jints, jfloats)))
    ps, single = prepare(got_c, got_b, "cpu")
    do, _ = state_planes(ps.r, ps.sc, ps.t, ps.sv)
    rows = [i for i in range(single.shape[0]) if i != do["totals"]]
    want_single = [solve_plain(PARAMS, ps, single, torch.from_numpy(i),
                               torch.from_numpy(f))
                   for i, f, _, _ in halves]
    for shards, batch_axis in MESHES:
        jbe = JaxShardedBackend(jax_make_mesh(shards, batch_axis=batch_axis))
        jstatic, jstate = jbe.prepare(ref_c, ref_b)
        be = ShardedBackend(make_mesh(shards, batch_axis, device="cpu"))
        ss, st = be.prepare(got_c, got_b)
        for (i, f, ji, jf), want_one in zip(halves, want_single):
            want, jstate = jbe.solve(JaxParams(), jstatic, jstate, ji, jf)
            got = be.solve(PARAMS, ss, st, i, f)
            np.testing.assert_array_equal(got, np.asarray(want))
            np.testing.assert_array_equal(got, want_one.numpy())
        np.testing.assert_array_equal(st.planes.numpy(),
                                      np.asarray(jstate.planes))
        assert st.totals.shape == (shards // batch_axis, ps.t)
        for s in range(shards // batch_axis):
            np.testing.assert_array_equal(st.totals[s].numpy(),
                                          np.asarray(jstate.totals))
            assert torch.equal(st.totals[s], single[do["totals"], :ps.t])
        assert torch.equal(st.planes[rows], single[rows])
        assert be.solves == 2


def test_encoder_node_shards_equal_one_thread_and_the_reference():
    """``BatchEncoder(node_shards=4)`` over 600 nodes fills the same
    arrays as ``node_shards=1`` and the JAX encoder (which splits its
    fill at that width), profiles with node selectors and preferences
    included."""
    nodes = [_node(f"n{i}", str(4 + i % 5), "16Gi",
                   **{ZONE: f"z{i % 7}", "tier": "gold" if i % 4 else "std"})
             for i in range(600)]
    pods = [_pod(f"p{i}", "1", {"app": f"a{i % 3}"},
                 nodeSelector={"tier": "gold"} if i % 3 == 0 else {},
                 affinity={"nodeAffinity": {
                     "preferredDuringSchedulingIgnoredDuringExecution": [{
                         "weight": 7, "preference": {"matchExpressions": [{
                             "key": ZONE, "operator": "In",
                             "values": ["z1", "z2"]}]}}]}}
                 if i % 3 == 1 else {})
            for i in range(24)]
    snap = new_snapshot([], [Node.from_dict(d) for d in nodes])
    split = BatchEncoder(snap, node_shards=4).encode(
        [Pod.from_dict(p) for p in pods], pad_pods=32)
    one = BatchEncoder(snap).encode([Pod.from_dict(p) for p in pods],
                                    pad_pods=32)
    _, ref = encoders(nodes, [])
    want = ref.encode([JaxPod.from_dict(p) for p in pods], pad_pods=32)
    for got, other in ((split, one), (split, want)):
        for g, w in zip(got, other):
            for k in ("allocatable", "requested", "nonzero_requested",
                      "pod_count", "max_pods", "static_masks",
                      "affinity_masks", "static_scores", "sc_domain",
                      "term_counts", "requests", "profile_idx"):
                if hasattr(g, k):
                    np.testing.assert_array_equal(getattr(g, k),
                                                  getattr(w, k), err_msg=k)
    assert split[1].static_masks.shape[0] == 3
    assert split[1].static_masks[0].sum() < 600


# ----------------------------------------------------------------------
# the workload level
def _random_cluster(rng, n_nodes):
    """``test_differential._random_cluster`` as dicts: four zones, gold
    and std tiers, every tenth node tainted dedicated=batch."""
    nodes = []
    for i in range(n_nodes):
        d = _node(f"n{i:04d}", str(rng.choice([8, 16, 32])),
                  f"{rng.choice([16, 32, 64])}Gi",
                  **{ZONE: f"z{i % 4}", "tier": "gold" if i % 4 == 0
                     else "std"})
        if i % 10 == 9:
            d["spec"] = {"taints": [{"key": "dedicated", "value": "batch",
                                     "effect": "NoSchedule"}]}
        nodes.append(d)
    return nodes


def _expr(key, values):
    return {"matchExpressions": [{"key": key, "operator": "In",
                                  "values": values}]}


def _random_pods(rng, count, apps=20):
    """``test_differential._random_pods(rng, count, priorities=False)`` as
    dicts: hard and soft zone spreads in dedicated label groups, hostname
    anti-affinity required and preferred, node selectors, required and
    preferred node affinity, tolerations, plain pods."""
    pods = []
    for i in range(count):
        app = f"a{i % apps}"
        labels = {"app": app}
        spec = {"containers": [{"name": "c", "resources": {"requests": {
            "cpu": f"{rng.choice([100, 250, 500, 1000])}m",
            "memory": f"{rng.choice([128, 256, 512])}Mi"}}}]}
        kind = rng.randrange(12)
        if kind in (0, 6):
            grp = f"{'sp' if kind == 0 else 'ss'}{i % 6}"
            labels["app"] = grp
            spec["topologySpreadConstraints"] = [{
                "maxSkew": 2 if kind == 0 else 3, "topologyKey": ZONE,
                "whenUnsatisfiable": "DoNotSchedule" if kind == 0
                else "ScheduleAnyway",
                "labelSelector": {"matchLabels": {"app": grp}}}]
        elif kind == 1:
            spec["affinity"] = {"podAntiAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [{
                    "labelSelector": _expr("app", [app]),
                    "topologyKey": HOST}]}}
        elif kind == 2:
            spec["nodeSelector"] = {"tier": "gold"}
        elif kind == 3:
            spec["affinity"] = {"nodeAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": {
                    "nodeSelectorTerms": [_expr(ZONE, ["z0", "z1"])]}}}
        elif kind == 4:
            spec["affinity"] = {"nodeAffinity": {
                "preferredDuringSchedulingIgnoredDuringExecution": [{
                    "weight": 10, "preference": _expr("tier", ["gold"])}]}}
        elif kind == 5:
            spec["affinity"] = {"podAntiAffinity": {
                "preferredDuringSchedulingIgnoredDuringExecution": [{
                    "weight": 5, "podAffinityTerm": {
                        "labelSelector": _expr("app", [app]),
                        "topologyKey": HOST}}]}}
        elif kind == 7:
            spec["tolerations"] = [{"key": "dedicated", "operator": "Equal",
                                    "value": "batch",
                                    "effect": "NoSchedule"}]
        pods.append({"metadata": {"name": f"p{i:05d}", "uid": f"u{i}",
                                  "labels": labels}, "spec": spec})
    return pods


def sharded_arm(nodes, ref, backend=None, mirror=True, max_batch=64,
                pipeline=True):
    """Either package's batch loop over ``nodes`` on a backend: the JAX
    one's ``ShardedBackend`` over ``make_mesh(8, batch_axis=2)`` by
    default; the port's CPU ``backend`` (None: its default batch path)."""
    if ref:
        store = JaxStore()
        for d in nodes:
            store.add_node(JaxNode.from_dict(copy.deepcopy(d)))
        sched = JaxScheduler.create(
            store, config=KubeSchedulerConfiguration(parallelism=1),
            feature_gates=FeatureGates({"TPUBatchScheduler": True}))
        bs = attach_batch_scheduler(
            sched, max_batch=max_batch, adaptive_chunk=False,
            pipeline=pipeline,
            backend=backend or JaxShardedBackend(
                jax_make_mesh(8, batch_axis=2)))
        make = JaxPod.from_dict
    else:
        store = ClusterStore()
        for d in nodes:
            store.add_node(Node.from_dict(copy.deepcopy(d)))
        sched = Scheduler(store, rng=random.Random(0))
        bs = BatchScheduler(sched, max_batch=max_batch, device="cpu",
                            mirror=mirror, pipeline=pipeline,
                            backend=backend)
        make = Pod.from_dict
    sched.start()
    return type("Arm", (), dict(
        store=store, sched=sched, bs=bs, pod=staticmethod(make),
        set_cpu=staticmethod(lambda n, c: _port_set_cpu(store, n, c))))


def _bound(nodes, pods, ref, backend=None, waves=1, **kw):
    arm = sharded_arm(nodes, ref, backend, **kw)
    try:
        step = -(-len(pods) // waves)
        for lo in range(0, len(pods), step):
            arm.store.create_pods([arm.pod(copy.deepcopy(d))
                                   for d in pods[lo:lo + step]])
            pump(arm)
        return {p.metadata.name: p.spec.node_name
                for p in arm.store.list_pods()}, arm
    finally:
        arm.sched.stop()


@pytest.mark.parametrize("seed", [11, 47, 83])
def test_differential_workload_through_the_sidecar(seed):
    """``test_differential.py::TestShardedEquivalence``'s inputs (200
    nodes, 600 pods of the randomized mix, its three seeds) through the
    port's sidecar on ``ShardedBackend(make_mesh(8, batch_axis=2))``: the
    same pod -> node map as the port's batch path and the JAX sharded
    arm."""
    rng = random.Random(seed)
    nodes, pods = _random_cluster(rng, 200), _random_pods(rng, 600)
    sharded, arm = _bound(nodes, pods, False, ShardedBackend(
        make_mesh(8, batch_axis=2, device="cpu")), waves=2, max_batch=128)
    assert arm.bs.session.backend.name == "sharded"
    assert arm.bs.session.backend.solves > 0
    batch, _ = _bound(nodes, pods, False, waves=2, max_batch=128)
    ref, _ = _bound(nodes, pods, True, waves=2, max_batch=128)
    assert sharded == batch == ref
    assert sum(1 for v in sharded.values() if v) > 500


def test_shared_volumes_on_the_sharded_tier():
    """``test_sharedvolumes.py``'s sharded case: 48 pods over four shared
    RWX CSI claims on eight nodes with an attach limit of 2, on a 4-shard
    mesh: the same nodes as the port's batch path and the JAX sharded arm,
    no node over 2 volumes, the sv planes carried (SV = 8)."""
    nodes = [node_dict(i) for i in range(8)]
    pods = [pod_dict(f"p{i}", claim(f"claim{i % 4}")) for i in range(48)]
    got = {}
    for name, ref, backend in (
            ("sharded", False, ShardedBackend(make_mesh(
                8, batch_axis=2, device="cpu"))),
            ("batch", False, None), ("reference", True, None)):
        arm = sharded_arm(nodes, ref, backend, max_batch=64)
        tw = Twin(ref, arm.store)
        for i in range(8):
            tw.csi_node(f"n{i}", "csi.x", 2)
        tw.sc("csi", provisioner="csi.x")
        for c in range(4):
            tw.pair(f"claim{c}", sc="csi", driver="csi.x",
                    modes=["ReadWriteMany"])
        try:
            arm.store.create_pods([arm.pod(copy.deepcopy(d)) for d in pods])
            pump(arm)
            got[name] = {p.metadata.name: p.spec.node_name
                         for p in arm.store.list_pods()}
            if name == "sharded":
                assert arm.bs.session._static.sv == 8
                assert arm.bs.session.backend.solves > 0
        finally:
            arm.sched.stop()
    assert got["sharded"] == got["batch"] == got["reference"]
    assert all(got["sharded"].values())
    per_node = {}
    for pod_name, node in got["sharded"].items():
        per_node.setdefault(node, set()).add(int(pod_name[1:]) % 4)
    assert max(len(v) for v in per_node.values()) <= 2


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_mirror_on_equals_off_on_the_sharded_tier(shards):
    """``test_mirror.py::TestMeshDifferential`` on the port: capacity
    churn then pod deletes, the mirror's scatters landing in the sharded
    planes, bind as the mirror-off arm and the single-card batch path."""
    def arm(nodes, mirror, **kw):
        return sharded_arm(nodes, False, ShardedBackend(
            make_mesh(shards, device="cpu")), mirror=mirror, max_batch=32)

    on, info = _scenario(arm, "capacity_churn", 3, True)
    off, _ = _scenario(arm, "capacity_churn", 3, False)
    single, _ = _scenario(lambda nodes, mirror, **kw: sharded_arm(
        nodes, False, mirror=mirror, max_batch=32), "capacity_churn", 3, True)
    assert on == off == single
    assert len(on) == 64 - 6
    assert info["events"] > 0 and info["catch_ups"] > 0


# ----------------------------------------------------------------------
# the tiering guards
@pytest.fixture
def no_mesh_allowed(monkeypatch):
    def boom(*_a, **_k):
        raise AssertionError("default_backend built a mesh")

    monkeypatch.setattr(parallel, "make_mesh", boom)
    monkeypatch.setattr(parallel, "ShardedBackend", boom)


def test_one_device_never_builds_a_mesh(monkeypatch, no_mesh_allowed):
    monkeypatch.delenv("KTPU_SOLVER", raising=False)
    be = session_mod.default_backend("cpu")
    assert isinstance(be, CudaPlanesBackend) and be.name == "cuda-planes"
    assert not hasattr(be, "mesh") and be.encode_shards == 1


def test_solver_env_forces_the_sharded_tier(monkeypatch):
    monkeypatch.setenv("KTPU_SOLVER", "sharded")
    be = session_mod.default_backend("cpu")
    assert be.name == "sharded" and be.mesh.shape == {"batch": 1, "nodes": 1}
    assert be.device.type == "cpu" and be.donate


def test_mesh_width_is_the_largest_power_of_two():
    assert [session_mod._mesh_width(n) for n in (1, 2, 3, 5, 6, 8, 9, 16)] \
        == [1, 2, 2, 4, 4, 8, 8, 16]


def test_make_mesh_shapes_and_refusals():
    mesh = make_mesh(8, batch_axis=2, device="cpu")
    assert mesh.shape == {"batch": 2, "nodes": 4}
    assert make_mesh(device="cpu").shape == {"batch": 1, "nodes": 1}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_mesh(2, device=["cuda:0", "cuda:1"])
    with pytest.raises(ValueError):
        make_mesh(6, batch_axis=4, device="cpu")


def test_staging_arm_counts_the_planes_both_ways():
    """``donate=False`` reads the carried planes back and uploads them
    again every solve, and counts those bytes; the assignments and state
    equal the resident arm's."""
    got_c, got_b, _, _ = _encode("spread_and_affinity")
    ints, floats = pack_podin(got_b)
    out = []
    for donate in (True, False):
        be = ShardedBackend(make_mesh(4, device="cpu"), donate=donate)
        ss, st = be.prepare(got_c, got_b)
        be.take_transfer_bytes()
        assign = be.solve(PARAMS, ss, st, ints, floats)
        moved = be.take_transfer_bytes()
        plane_bytes = sum(t.numel() * 4 for t in st)
        if donate:
            assert moved["d2h"] == assign.nbytes
        else:
            assert moved["d2h"] == plane_bytes + assign.nbytes
            assert moved["h2d"] >= plane_bytes + ints.nbytes
        out.append((assign, st.planes.clone(), st.totals.clone()))
    assert np.array_equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    assert torch.equal(out[0][2], out[1][2])


def test_padded_node_count_must_split():
    got_c, got_b, _, _ = _encode("basic_fit")
    with pytest.raises(ValueError, match="not divisible"):
        solve_scan_sharded(got_c, got_b, make_mesh(3, device="cpu"))


@pytest.mark.parametrize("bad", ["past the last", "negative"])
def test_out_of_range_profile_is_refused_before_any_upload(monkeypatch, bad):
    """``solve_scan_sharded`` checks the pods' profile indices on the
    host's numpy stream before anything reaches the mesh's device, as the
    single-card backend's ``solve_lazy`` does, so the counts kernel's bare
    launch (``profiles=False``) never waits on the card for it. (The JAX
    ``solve_scan_sharded`` has no such check: its gather clamps the
    index.)"""
    from kubernetes_tpu_torch.parallel import sharded as sharded_mod

    got_c, got_b, _, _ = _encode("basic_fit")
    got_b.profile_idx = got_b.profile_idx.copy()
    got_b.profile_idx[1] = (got_b.static_masks.shape[0]
                            if bad == "past the last" else -1)
    uploads = []
    real_to = torch.Tensor.to
    monkeypatch.setattr(sharded_mod, "_prepare_sharded",
                        lambda *a: uploads.append("planes"))
    monkeypatch.setattr(torch.Tensor, "to", lambda self, *a, **k: (
        uploads.append("pods"), real_to(self, *a, **k))[1])
    with pytest.raises(ValueError, match="profile index"):
        solve_scan_sharded(got_c, got_b, make_mesh(2, device="cpu"))
    assert uploads == []


@pytest.mark.parametrize("n,r,sc,t,u,sv", [
    (1280, 3, 1, 1, 1, 0), (640, 4, 2, 100, 2, 64), (8192, 3, 1, 1, 25, 0)])
def test_sharded_plan_is_the_wide_plan_with_the_winner_slots(n, r, sc, t, u,
                                                             sv):
    """The sharded kernel's launch over a shard's columns is the wide
    kernel's cut and tier rule on a layout four words longer."""
    wide = solve_mod.wide_candidate(n, r, sc, t, u, sv=sv)
    plan = solve_mod.wide_candidate(n, r, sc, t, u, sv=sv, kernel="sharded")
    assert plan.kernel == "sharded"
    assert (plan.cluster, plan.threads, plan.cols_per_block) == (
        wide.cluster, wide.threads, wide.cols_per_block)
    assert plan.smem_bytes == solve_mod.sharded_smem_bytes(
        r, sc, t, u, plan.cluster, plan.threads, plan.cols_per_block,
        plan.chunk, sv, solve_mod.wide_slices(plan, r, sc, t, u, sv))
    if plan.chunk == wide.chunk:
        assert plan.smem_bytes == wide.smem_bytes + 16


def test_exchange_error_words():
    solve_mod.check_exchange(0)
    for code, text in ((1, "ran out"), (2, "hard spread"), (7, "error 7")):
        with pytest.raises(RuntimeError, match=text):
            solve_mod.check_exchange(code)
    # flags of two rounds, two parities, a line each; the error word; the
    # offers and the domain minima
    assert solve_mod.exchange_words(4, 2, 3) == (
        4 * 4 * 32 + 32 + 2 * 4 * 7 + 2 * 4 * 2)
    assert solve_mod.exchange_error_word(4) == 4 * 4 * 32


def _blocks(plan, shards, n):
    """Each block of a sharded launch as the kernel places it: (shard,
    first column, columns). One cluster: shard ``rank // g``, the ``rank
    % g``-th block of it; the global route: cluster ``s`` of the grid is
    shard ``s``, its ``rank``-th block."""
    nl = n // shards
    g = solve_mod.sharded_groups(plan, shards, n)
    ranks = ([(r // g, r % g) for r in range(plan.cluster)] if g else
             [(s, q) for s in range(shards) for q in range(plan.cluster)])
    return [(s, s * nl + q * plan.cols_per_block,
             max(0, min(plan.cols_per_block,
                        nl - q * plan.cols_per_block))) for s, q in ranks]


@pytest.mark.parametrize("max_cluster", [16, 8])
@pytest.mark.parametrize("n,shards", [
    (5120, 1), (5120, 2), (5120, 4), (5120, 8), (5120, 16), (1024, 16),
    (640, 4), (1536, 3), (1536, 6), (5120, 5), (4096, 32), (65536, 2)])
def test_each_shard_block_group_covers_its_columns_once(n, shards,
                                                        max_cluster):
    """Every column of the mesh is one block's, and every block's columns
    lie in its own shard, on either route; no block of the one-cluster
    route is empty."""
    nl = n // shards
    plan = solve_mod.wide_candidate(nl, 4, 2, 3, 2, max_cluster=max_cluster,
                                    kernel="sharded", shards=shards)
    owner = np.full(n, -1)
    for b, (s, lo, cols) in enumerate(_blocks(plan, shards, n)):
        assert s * nl <= lo and lo + cols <= (s + 1) * nl or cols == 0
        assert (owner[lo:lo + cols] == -1).all()
        owner[lo:lo + cols] = b
        if solve_mod.sharded_groups(plan, shards, n):
            assert cols > 0
    assert (owner >= 0).all()
