"""The port's legacy per-pod scan (``ops/solver.py``: the plain loop the
CPU runs and ``solve_scan_kernel`` is held against) against the JAX
package's ``solve_scan``, ``_solve_packed`` and ``solve_whatif``, on
batches the JAX encoder builds from seeded clusters and pods (zone and
hostname keys, so V = N for the latter; hard and soft spread; required
and preferred (anti-)affinity; host-port pods, which the encoder marks
inexpressible; padded rows). The what-ifs append template nodes as
extra columns and use the autoscaler's graded penalty tiers, hundreds of
columns deep, with disabled columns. Also the port's encoder with
``extra_nodes`` against the JAX encoder's. Tolerance: exact equality of
assignments, per-column counts and every final table."""

import copy

import numpy as np
import pytest
import torch

from kubernetes_tpu.api.types import Node as JaxNode, Pod as JaxPod
from kubernetes_tpu.ops import solver as jax_solver
from kubernetes_tpu.ops.encode import BatchEncoder as JaxEncoder
from kubernetes_tpu.scheduler.snapshot import new_snapshot as jax_snapshot
from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.harness.problems import whatif_problem
from kubernetes_tpu_torch.ops import solver
from kubernetes_tpu_torch.ops.encode import BatchEncoder, is_host_only
from kubernetes_tpu_torch.scheduler.snapshot import new_snapshot
from test_torch_framework import cluster_dicts, pending_dicts

PARAMS = solver.SolverParams()
JAX_PARAMS = jax_solver.SolverParams()
UPCOMING = 5.0e5
STEP = 1000.0


def template(i, cpu="8"):
    return {"metadata": {"name": f"v{i}", "labels": {
        "kubernetes.io/hostname": f"v{i}",
        "topology.kubernetes.io/zone": f"z{i % 3}"}},
        "status": {"capacity": {"cpu": cpu, "memory": "16Gi",
                                "pods": "12"}}}


def jax_encode(nodes, existing, pending, extra=(), pad=64):
    snap = jax_snapshot([JaxPod.from_dict(copy.deepcopy(d)) for d in existing],
                        [JaxNode.from_dict(copy.deepcopy(d)) for d in nodes])
    enc = JaxEncoder(snap, extra_nodes=[JaxNode.from_dict(copy.deepcopy(d))
                                        for d in extra])
    return enc.encode([JaxPod.from_dict(copy.deepcopy(d)) for d in pending],
                      pad_pods=pad)


def port_final(cluster, batch):
    """The port's plain scan: assignments and the final tables."""
    static, state, ints, floats = solver.scan_inputs(cluster, batch, "cpu")
    a = solver.solve_packed(PARAMS, static, state, ints, floats)
    return a.numpy(), [t.numpy() for t in state]


def jax_final(cluster, batch):
    static = jax_solver.build_static(cluster, batch)
    state = jax_solver.build_state(cluster, batch)
    ints, floats = jax_solver.pack_podin(batch)
    final, a = jax_solver._solve_packed(static, state, ints, floats,
                                        JAX_PARAMS)
    return np.asarray(a), [np.asarray(x) for x in final]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("size", ((12, 24, 40), (40, 60, 100)))
def test_scan_equals_the_reference(seed, size):
    n_nodes, n_existing, n_pods = size
    nodes, existing = cluster_dicts(seed, n_nodes=n_nodes,
                                    n_existing=n_existing)
    pending = pending_dicts(seed, n_pods)
    cluster, batch = jax_encode(nodes, existing, pending,
                                pad=64 if n_pods < 64 else 128)
    assert batch.requests.shape[0] > batch.num_real_pods   # padded rows
    got = solver.solve_scan(cluster, batch, PARAMS, device="cpu")
    want = np.asarray(jax_solver.solve_scan(cluster, batch, JAX_PARAMS))
    np.testing.assert_array_equal(got, want)
    a, tables = port_final(cluster, batch)
    ra, rtables = jax_final(cluster, batch)
    np.testing.assert_array_equal(a, ra)
    for x, y in zip(tables, rtables):
        np.testing.assert_array_equal(x, y)
    assert (want >= 0).any() and (want[: batch.num_real_pods] < 0).any()


def _penalties(base, n_upcoming, n_virtual):
    cap = float(solver.VIRTUAL_NODE_PENALTY) - STEP
    out = {base + j: min(UPCOMING + j * STEP, cap)
           for j in range(n_upcoming)}
    out.update({base + n_upcoming + j:
                float(solver.VIRTUAL_NODE_PENALTY) + j * STEP
                for j in range(n_virtual)})
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("form", ("tiers", "list", "disabled"))
def test_whatif_equals_the_reference(seed, form):
    nodes, existing = cluster_dicts(seed, n_nodes=16, n_existing=30)
    pending = pending_dicts(seed, 150)
    extra = [template(i) for i in range(10)]
    cluster, batch = jax_encode(nodes, existing, pending, extra, pad=256)
    rng = np.random.default_rng(seed)
    pen, disabled = (), ()
    if form == "tiers":
        pen = _penalties(16, 4, 6)
    elif form == "list":
        pen = list(range(16, 26))
    else:
        pen = _penalties(16, 0, 10)
        disabled = [int(c) for c in rng.choice(16, 4, replace=False)]
    got = solver.solve_whatif(cluster, batch, PARAMS, pen, disabled,
                              device="cpu")
    want = jax_solver.solve_whatif(cluster, batch, JAX_PARAMS, pen, disabled)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, np.asarray(y))
    assert got[1][16:26].sum() > 0
    for c in disabled:
        assert got[1][c] == 0


@pytest.mark.parametrize("seed", (0, 1))
def test_graded_tiers_hundreds_of_columns_deep(seed):
    """Few real nodes, 300 upcoming and 200 virtual columns and 400
    pending pods: the f32 sums at the penalty tiers (spacing 0.0625)
    decide the argmax alike; the upcoming columns fill first, in order."""
    rng = np.random.default_rng(seed)
    nodes, existing = cluster_dicts(seed, n_nodes=6, n_existing=10)
    pending = [{"metadata": {"name": f"w{i}", "uid": f"u-w{i}",
                             "labels": {"app": "w"}},
                "spec": {"containers": [{"name": "c", "resources": {
                    "requests": {"cpu": f"{int(rng.choice([250, 500]))}m",
                                 "memory": "256Mi"}}}]}}
               for i in range(400)]
    extra = [template(i, cpu="2") for i in range(500)]
    cluster, batch = jax_encode(nodes, existing, pending, extra, pad=512)
    pen = _penalties(6, 300, 200)
    got = solver.solve_whatif(cluster, batch, PARAMS, pen, device="cpu")
    want = jax_solver.solve_whatif(cluster, batch, JAX_PARAMS, pen)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, np.asarray(y))
    counts = got[1]
    assert counts[6:306].sum() > 0 and counts[306:].sum() == 0


@pytest.mark.parametrize("seed", range(3))
def test_encoder_extra_nodes_equal_the_reference(seed):
    nodes, existing = cluster_dicts(seed, n_nodes=14, n_existing=20)
    pending = [d for d in pending_dicts(seed, 30)
               if not is_host_only(Pod.from_dict(copy.deepcopy(d)))]
    extra = [template(i) for i in range(5)]
    snap = new_snapshot([Pod.from_dict(copy.deepcopy(d)) for d in existing],
                        [Node.from_dict(copy.deepcopy(d)) for d in nodes])
    enc = BatchEncoder(snap, extra_nodes=[Node.from_dict(copy.deepcopy(d))
                                          for d in extra])
    cluster, batch = enc.encode([Pod.from_dict(copy.deepcopy(d))
                                 for d in pending], pad_pods=64)
    ref_snap = jax_snapshot(
        [JaxPod.from_dict(copy.deepcopy(d)) for d in existing],
        [JaxNode.from_dict(copy.deepcopy(d)) for d in nodes])
    ref = JaxEncoder(ref_snap, extra_nodes=[
        JaxNode.from_dict(copy.deepcopy(d)) for d in extra])
    rcluster, rbatch = ref.encode(
        [JaxPod.from_dict(copy.deepcopy(d)) for d in pending], pad_pods=64)
    assert enc.num_snapshot_nodes == ref.num_snapshot_nodes == 14
    assert cluster.node_names == rcluster.node_names
    assert cluster.node_names[14:] == [f"v{i}" for i in range(5)]
    assert cluster.num_real_nodes == rcluster.num_real_nodes == 19
    for name in ("allocatable", "requested", "max_pods", "topo_codes"):
        np.testing.assert_array_equal(getattr(cluster, name),
                                      getattr(rcluster, name))
    for name in ("static_masks", "static_scores", "sc_counts", "sc_domain",
                 "term_counts", "term_owners", "profile_idx"):
        np.testing.assert_array_equal(getattr(batch, name),
                                      getattr(rbatch, name))
    got = solver.solve_whatif(cluster, batch, PARAMS, _penalties(14, 0, 5),
                              device="cpu")
    want = jax_solver.solve_whatif(rcluster, rbatch, JAX_PARAMS,
                                   _penalties(14, 0, 5))
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, np.asarray(y))


@pytest.mark.parametrize("seed,host_key", ((0, True), (1, False), (2, True)))
def test_whatif_problems_equal_the_reference(seed, host_key):
    """The seeded what-if problems the scan kernel is held against on the
    card (``whatif_problem``: the port's encoder, graded tiers, disabled
    columns, padded rows), through both packages' ``solve_whatif``."""
    cluster, batch, pen, dis = whatif_problem(seed, host_key=host_key)
    got = solver.solve_whatif(cluster, batch, PARAMS, pen, dis, device="cpu")
    want = jax_solver.solve_whatif(cluster, batch, JAX_PARAMS, pen, dis)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, np.asarray(y))
    assert got[1][cluster.num_real_nodes - 24:].sum() > 0
    assert all(got[1][c] == 0 for c in dis)


def test_kernel_input_check_refuses_what_it_cannot_take():
    """The scan kernel's wrapper refuses, before any launch, a wrong
    dtype, a profile index past U and a topology code past V (it reads
    them as indices); valid inputs pass."""
    cluster, batch, pen, dis = whatif_problem(0, n_pods=20, pad=32)
    static, state, ints, floats = solver.scan_inputs(cluster, batch, "cpu")
    solver.ScanKernel.check(static, state, ints, floats)
    v = static.sc_domain.shape[2] - 1
    bad = [
        (static._replace(node_valid=static.node_valid.to(torch.int64)),
         ints, "contiguous"),
        (static, ints.clone().index_fill_(1, torch.tensor([
            static.allocatable.shape[1] + 2]), 7), "profile"),
        (static._replace(term_codes=static.term_codes + v + 1), ints,
         "topology code"),
    ]
    for st, pi, match in bad:
        with pytest.raises(ValueError, match=match):
            solver.ScanKernel.check(st, state, pi, floats)


def test_sv_batches_are_refused():
    nodes, existing = cluster_dicts(0)
    cluster, batch = jax_encode(nodes, existing, pending_dicts(0, 4))
    batch.pod_sv = np.zeros((batch.requests.shape[0], 2), dtype=np.int32)
    with pytest.raises(ValueError, match="shared-volume"):
        solver.solve_scan(cluster, batch, device="cpu")


# ----------------------------------------------------------------------
# the kernel's launch plan (plain Python; the kernel refuses a launch
# whose byte count disagrees with its own layout)
LIMIT = 232448


def layout_words(r, sc, t, v, n_cols, chunk, tables, cols):
    """The layout's arithmetic, spelled out: the warp winners' two
    halves (64-bit slots), tables, totals, column arrays, two buffers of
    pod rows and weights, the facts, the domain minima."""
    width = r + 4 + 2 * sc + 3 * t
    return (2 * 32 * 2 + (sc + 2 * t) * (v + 1) * tables + t
            + (2 * sc + 3 * t) * n_cols * cols
            + 2 * chunk * width + 2 * chunk * t
            + chunk * ((16 + 3 * sc + 2 * t + 3) // 4 * 4)
            + sc * 32)


@pytest.mark.parametrize("n", (1, 31, 512, 1024, 1025, 1536, 5400))
@pytest.mark.parametrize("tables", (None, True, False))
@pytest.mark.parametrize("b", (0, 64, 2048))
@pytest.mark.parametrize("dims", ((3, 1, 1), (3, 18, 15)),
                         ids=("plain", "constrained"))
def test_scan_plan_covers_n_and_fits(n, tables, b, dims):
    """threads x k covers N with no spare warp, the block sizes are the
    instances', the chunk is the largest that fits (at most 32 and B),
    and the bytes equal the layout's arithmetic, within one block's
    shared memory; with hostname keys (V = N). A forced placement that
    no chunk fits raises ValueError."""
    r, sc, t = dims
    v = n
    try:
        plan = solver.scan_plan(r, sc, t, v, n, b, tables=tables)
    except ValueError:
        # even N columns (at most k x threads) and one pod do not fit
        assert tables is not None
        assert all(4 * layout_words(r, sc, t, v, n, 1, tables, cols) > LIMIT
                   for cols in (True, False))
        return
    assert plan.k in (1, 2, 4, 8)
    assert plan.threads % 32 == 0 and plan.threads >= 32
    assert plan.threads * plan.k >= n > (plan.threads - 32) * plan.k
    assert plan.threads <= (1024 if plan.k == 8 else 512)
    assert plan.k == 8 or n <= 512 * plan.k
    assert plan.k == 1 or n > 512 * (plan.k // 2)
    assert tables is None or plan.tables_in_smem == tables
    assert 1 <= plan.chunk <= min(32, max(b, 1))
    n_cols = plan.k * plan.threads
    words = layout_words(r, sc, t, v, n_cols, plan.chunk,
                         plan.tables_in_smem, plan.cols_in_smem)
    assert plan.smem_bytes == 4 * words <= LIMIT
    # nothing larger fits: not the next chunk, not a placement tried first
    if plan.chunk < min(32, max(b, 1)):
        assert all(4 * layout_words(r, sc, t, v, n_cols, 2 * plan.chunk,
                                    tb, c) > LIMIT
                   for c in (True, False) for tb in (True, False)
                   if tables in (None, tb))
    if tables is None and not plan.tables_in_smem:
        assert 4 * layout_words(r, sc, t, v, n_cols, plan.chunk,
                                True, plan.cols_in_smem) > LIMIT
    if not plan.cols_in_smem:
        assert all(4 * layout_words(r, sc, t, v, n_cols, plan.chunk, tb,
                                    True) > LIMIT
                   for tb in (True, False) if tables in (None, tb))


def test_scan_plan_refuses_what_no_instance_takes():
    with pytest.raises(ValueError, match="covers"):
        solver.scan_plan(3, 1, 1, 8, 8193, 64)
    with pytest.raises(ValueError, match="covers"):
        solver.scan_plan(3, 1, 1, 8, 513, 64, k=1)
    with pytest.raises(ValueError, match="one of"):
        solver.scan_plan(3, 1, 1, 8, 512, 64, k=3)
    with pytest.raises(ValueError, match="fits"):
        solver.scan_plan(3, 4000, 4000, 8, 512, 64)
    plan = solver.scan_plan(3, 1, 1, 8, 512, 64, k=4)
    assert (plan.k, plan.threads) == (4, 128)


def test_scan_plan_of_the_kernel_wrapper_reads_the_dims():
    cluster, batch, pen, dis = whatif_problem(0, n_pods=20, pad=32)
    static, state, ints, floats = solver.scan_inputs(cluster, batch, "cpu")
    r, sc, t, _, v, n = solver._scan_dims(static)
    assert solver.ScanKernel.plan(static, ints.shape[0]) == \
        solver.scan_plan(r, sc, t, v, n, ints.shape[0])
    assert solver.ScanKernel.plan(static, 5, tables=False).chunk == 5


def test_scan_arrays_want_an_explicit_device():
    """``build_static`` and ``build_state`` have no default device: a
    caller that names none fails with TypeError; one that names the CPU
    gets the same arrays ``scan_inputs`` builds."""
    cluster, batch, _, _ = whatif_problem(0, n_pods=20, pad=32)
    with pytest.raises(TypeError):
        solver.build_static(cluster, batch)
    with pytest.raises(TypeError):
        solver.build_state(cluster, batch)
    static = solver.build_static(cluster, batch, "cpu")
    state = solver.build_state(cluster, batch, "cpu")
    want_static, want_state, _, _ = solver.scan_inputs(cluster, batch, "cpu")
    for got, want in zip((*static, *state), (*want_static, *want_state)):
        assert got.device.type == "cpu"
        assert torch.equal(got, want)
