"""The solve kernels' launch plan (``ops/solve.py::plan_launch``): which
kernel runs, on what cluster, and that the plan always covers every node
column inside one block's shared memory. Pure Python; no card needed.

The wide kernel took the shapes the one-block kernel (one block over all
columns, planes in global memory) took before it: the tests whose names
still say "one block" hold those shapes to the wide plan."""

import numpy as np
import pytest

from kubernetes_tpu_torch.ops.slots import SPARSE_K, slot_stream
from kubernetes_tpu_torch.ops.solve import (
    CLUSTER_THREADS,
    POD_CHUNK,
    SMEM_LIMIT,
    cluster_candidate,
    cluster_smem_bytes,
    plan_launch,
    sharded_groups,
    slot_cache,
    slots_candidate,
    slots_smem_bytes,
    wide_candidate,
    wide_slices,
    wide_smem_bytes,
)

SHAPES = [  # (n, r, sc, t, u)
    (5120, 3, 1, 1, 1),       # SchedulingBasic / TopologySpreading, 5k nodes
    (5120, 3, 16, 16, 16),    # the wide constraint space at 5k nodes
    (128, 3, 1, 1, 1),
    (1024, 3, 1, 1, 1),
    (1408, 3, 2, 3, 2),       # a ragged last slice
    (5248, 3, 1, 1, 1),
    (20480, 4, 4, 4, 4),      # more columns than threads in a block
    (5120, 3, 40, 40, 40),    # past the shared-memory budget
    (65536, 3, 1, 1, 1),
]


def test_scheduling_basic_runs_the_cluster_kernel():
    plan = plan_launch(5120, 3, 1, 1, 1)
    assert plan.kernel == "cluster"
    assert (plan.cluster, plan.threads, plan.cols_per_block) == (16, 320, 320)
    assert plan.smem_bytes < SMEM_LIMIT
    # 19 rows of 320 columns held (9 state, 9 static, a score row), plus
    # the pod staging and the reduction slots
    assert 19 * 320 * 4 <= plan.smem_bytes < 48 * 1024


def test_wide_space_at_5k_nodes_runs_the_cluster_kernel():
    plan = plan_launch(5120, 3, 16, 16, 16)
    assert plan.kernel == "cluster"
    assert plan.cluster == 16 and plan.cols_per_block == 320
    assert plan.smem_bytes <= SMEM_LIMIT


def test_small_plane_is_covered():
    plan = plan_launch(128, 3, 1, 1, 1)
    assert plan.kernel == "cluster"
    assert plan.cluster * plan.cols_per_block >= 128
    assert (plan.cluster - 1) * plan.cols_per_block < 128   # no empty block
    assert plan.threads % 32 == 0 and plan.threads >= 32


@pytest.mark.parametrize("shape", [(5120, 3, 40, 40, 40),
                                   (65536, 3, 1, 1, 1)])
def test_past_the_budget_runs_the_one_block_kernel(shape):
    n, r, sc, t, u = shape
    cols = -(-n // 16 // 32) * 32
    assert cluster_smem_bytes(r, sc, t, u, -(-n // cols), CLUSTER_THREADS,
                              cols, 32) > SMEM_LIMIT
    plan = plan_launch(*shape)
    assert plan == wide_candidate(n, r, sc, t, u)
    assert plan.kernel == "wide" and plan.cluster == 16
    assert plan.cols_per_block == cols
    assert plan.threads == min(cols, CLUSTER_THREADS)
    assert plan.chunk >= 1 and plan.smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("max_cluster", [16, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_every_plan_covers_every_column(shape, max_cluster):
    n, r, sc, t, u = shape
    plan = plan_launch(*shape, max_cluster=max_cluster)
    assert plan.cluster * plan.cols_per_block >= n
    assert plan.smem_bytes <= SMEM_LIMIT
    assert 1 <= plan.cluster <= max_cluster
    assert plan.cols_per_block % 32 == 0
    assert (plan.cluster - 1) * plan.cols_per_block < n
    assert plan.threads == min(plan.cols_per_block, CLUSTER_THREADS)
    if plan.kernel == "cluster":
        assert plan.smem_bytes == cluster_smem_bytes(
            r, sc, t, u, plan.cluster, plan.threads, plan.cols_per_block,
            plan.chunk)
    else:
        assert plan.kernel == "wide"
        assert plan.smem_bytes == wide_smem_bytes(
            r, sc, t, u, plan.cluster, plan.threads, plan.cols_per_block,
            plan.chunk, slices=wide_slices(plan, r, sc, t, u))


def test_ragged_last_slice():
    plan = plan_launch(1408, 3, 1, 1, 1)
    assert plan.kernel == "cluster"
    last = 1408 - (plan.cluster - 1) * plan.cols_per_block
    assert 0 < last < plan.cols_per_block


def test_portable_cluster_halves_the_blocks_and_doubles_the_slice():
    wide = plan_launch(5120, 3, 1, 1, 1, max_cluster=16)
    portable = plan_launch(5120, 3, 1, 1, 1, max_cluster=8)
    assert portable.cluster == 8
    assert portable.cols_per_block == 2 * wide.cols_per_block
    assert portable.threads == CLUSTER_THREADS   # two columns for some threads


@pytest.mark.parametrize("t", [50, 100])
def test_wide_terms_at_5k_nodes_run_the_slot_kernel(t):
    """SchedulingPodAffinity and SchedulingPreferredPodAffinity (T = 50),
    SchedulingPodAntiAffinity and SchedulingPreferredPodAntiAffinity
    (T = 100) at 5,000 nodes: past the dense cluster layout, so a batch
    that packs runs the slot kernel on the same cut of the node axis,
    staging chunks of ``POD_CHUNK`` pods, with 49 term lines in the rest
    of each block's shared memory."""
    dense = cluster_candidate(5120, 3, 1, t, 1)
    assert dense.smem_bytes > SMEM_LIMIT
    plan = plan_launch(5120, 3, 1, t, 1, packs=True)
    assert plan.kernel == "slots"
    assert (plan.cluster, plan.threads, plan.cols_per_block, plan.chunk) \
        == (dense.cluster, dense.threads, dense.cols_per_block, dense.chunk)
    assert plan.smem_bytes == slots_smem_bytes(3, 1, t, 1, 16, 320, 320,
                                               POD_CHUNK)
    assert plan.smem_bytes <= SMEM_LIMIT
    cache = slot_cache(3, 1, t, 1, 16, 320, 320, plan.chunk)
    assert cache.need == SPARSE_K and cache.lines == 49
    # 16 rows of 320 columns held (7 state, 8 static, a score row), three
    # rows a cache line
    assert 4 * (16 * 320 + cache.lines * 3 * 320) < plan.smem_bytes


def test_a_pod_of_nine_references_runs_the_one_block_kernel():
    r, sc, t = 3, 1, 100
    ints = np.zeros((4, r + 4 + 2 * sc + 3 * t), dtype=np.int32)
    floats = np.zeros((4, t), dtype=np.float32)
    ints[0, r + 4 + 2 * sc:r + 4 + 2 * sc + SPARSE_K] = 1
    assert slot_stream(ints, floats, r, sc, t) is not None
    floats[0, 50] = 2.0           # a ninth reference
    assert slot_stream(ints, floats, r, sc, t) is None
    plan = plan_launch(5120, r, sc, t, 1, packs=False)
    assert plan == wide_candidate(5120, r, sc, t, 1)
    assert plan.chunk == POD_CHUNK and wide_slices(plan, r, sc, t, 1)


@pytest.mark.parametrize("shape", [(5120, 3, 1, 12, 1), (5120, 3, 1, 38, 1),
                                   (256, 3, 1, 100, 1)])
def test_the_cluster_kernel_wins_when_its_dense_layout_fits(shape):
    plan = plan_launch(*shape, packs=True)
    assert plan.kernel == "cluster"
    assert plan == plan_launch(*shape)


@pytest.mark.parametrize("shape", SHAPES)
def test_every_packed_plan_covers_every_column(shape):
    n, r, sc, t, u = shape
    plan = plan_launch(*shape, packs=True)
    assert plan.cluster * plan.cols_per_block >= n
    assert plan.smem_bytes <= SMEM_LIMIT
    if plan.kernel == "slots":
        assert plan.smem_bytes == slots_smem_bytes(
            r, sc, t, u, plan.cluster, plan.threads, plan.cols_per_block,
            plan.chunk)
        assert plan_launch(*shape).kernel == "wide"


def _one_block_rule(n, r, sc, t, u, max_cluster, packs, sv):
    """The plan's choice before the wide kernel: the cluster kernel where
    its layout fits, the slot kernel for a batch that packs (no sv), the
    one-block kernel for the rest."""
    if cluster_candidate(n, r, sc, t, u, max_cluster, sv).smem_bytes \
            <= SMEM_LIMIT:
        return "cluster"
    if packs and not sv and slots_candidate(
            n, r, sc, t, u, max_cluster).smem_bytes <= SMEM_LIMIT:
        return "slots"
    return "block"


@pytest.mark.parametrize("max_cluster", [16, 8])
@pytest.mark.parametrize("packs", [False, True])
@pytest.mark.parametrize("sv", [0, 8, 512])
def test_only_the_one_block_shapes_move_to_the_wide_kernel(sv, packs,
                                                             max_cluster):
    """Over a grid of widths and constraint spaces, ``plan_launch`` gives
    the cluster and slot kernels every shape it gave them before, and
    the wide kernel every shape it gave the one-block kernel."""
    moved = 0
    for n in (128, 1024, 1408, 5120, 20480, 65536):
        for r, sc, u in ((3, 1, 1), (4, 2, 2), (3, 16, 16), (3, 40, 40)):
            for t in (1, 12, 38, 40, 100, 1024):
                if t > n:
                    continue
                was = _one_block_rule(n, r, sc, t, u, max_cluster, packs, sv)
                plan = plan_launch(n, r, sc, t, u, max_cluster=max_cluster,
                                   packs=packs, sv=sv)
                assert plan.kernel == {"block": "wide"}.get(was, was)
                if was == "block":
                    moved += 1
                    assert plan == wide_candidate(n, r, sc, t, u,
                                                  max_cluster, sv)
    assert moved > 0


WIDE_SHAPES = [  # (n, r, sc, t, u, sv): shapes the one-block kernel took
    *[(5120, 3, 2, t, 2, 0) for t in (40, 50, 64, 100, 128, 256, 512, 1024,
                                     2048, 4096)],
    (5120, 3, 1, 100, 1, 0),        # the anti-affinity row with wide pods
    (5120, 3, 40, 40, 40, 0),
    (65536, 3, 1, 1, 1, 0),
    (65536, 3, 1, 100, 1, 0),
    (5120, 4, 2, 40, 2, 8),
    (5120, 4, 40, 40, 2, 8),
    (5120, 4, 1, 100, 1, 512),
    (65536, 4, 1, 1, 1, 512),
]


@pytest.mark.parametrize("max_cluster", [16, 8])
@pytest.mark.parametrize("shape", WIDE_SHAPES)
def test_the_wide_plan_fits_what_the_one_block_kernel_took(shape,
                                                           max_cluster):
    """Each shape the one-block kernel took gets a wide plan that fits one
    block's shared memory, covers every column with the cluster kernel's
    cut, stages at least one pod a chunk, and stages the most pods that
    fit its tier; its bytes are the layout's, slices in shared memory
    exactly when that layout fits."""
    n, r, sc, t, u, sv = shape
    assert _one_block_rule(n, r, sc, t, u, max_cluster, False, sv) == "block"
    plan = plan_launch(n, r, sc, t, u, max_cluster=max_cluster, sv=sv)
    cut = cluster_candidate(n, r, sc, t, u, max_cluster, sv)
    assert plan.kernel == "wide"
    assert (plan.cluster, plan.threads, plan.cols_per_block) == (
        cut.cluster, cut.threads, cut.cols_per_block)
    assert plan.cluster * plan.cols_per_block >= n
    assert (plan.cluster - 1) * plan.cols_per_block < n
    assert 1 <= plan.chunk <= POD_CHUNK
    assert plan.smem_bytes <= SMEM_LIMIT
    slices = wide_slices(plan, r, sc, t, u, sv)
    args = (r, sc, t, u, plan.cluster, plan.threads, plan.cols_per_block)
    assert plan.smem_bytes == wide_smem_bytes(*args, plan.chunk, sv, slices)
    if plan.chunk < POD_CHUNK:
        assert wide_smem_bytes(*args, plan.chunk + 1, sv, slices) \
            > SMEM_LIMIT
    if not slices:
        assert all(wide_smem_bytes(*args, ch, sv, True) > SMEM_LIMIT
                   for ch in range(POD_CHUNK + 1))
    # shared memory does not grow with the slices' term rows: at most
    # the pod chunks, one pod's facts and one word a term for the totals
    assert plan.smem_bytes < cut.smem_bytes


def test_past_one_pod_the_wide_plan_reads_rows_in_place():
    """Where not even one pod's rows fit beside the totals and its facts
    (65,536 columns, 20,000 terms), the plan stages none (chunk 0) and
    keeps every slice at L2; the forced chunk keeps its tier's rule."""
    plan = wide_candidate(65536, 3, 1, 20000, 1)
    assert plan.chunk == 0 and plan.smem_bytes <= SMEM_LIMIT
    assert not wide_slices(plan, 3, 1, 20000, 1)
    assert wide_smem_bytes(3, 1, 20000, 1, 16, 512, 4096, 1,
                           slices=False) > SMEM_LIMIT
    assert plan.smem_bytes == 4 * (4096 + 20000 + 2 + (8 + 3 + 20000)
                                   + 3 * 16 + 2 * 16 * 3)
    for chunk in (0, 1, 7):
        forced = wide_candidate(5120, 3, 1, 100, 1, chunk=chunk)
        assert forced.chunk == chunk and wide_slices(forced, 3, 1, 100, 1)
        assert forced.smem_bytes == wide_smem_bytes(3, 1, 100, 1, 16, 320,
                                                    320, chunk)


SLOT_SHAPES = [  # (n, r, sc, t, u): shapes the slot route may take
    (640, 3, 1, 100, 1), (1408, 3, 2, 40, 2), (5120, 3, 1, 12, 1),
    (5120, 3, 1, 50, 1), (5120, 3, 1, 100, 1), (5120, 4, 2, 100, 2),
    (5120, 3, 1, 200, 1), (5120, 3, 1, 1024, 1), (10240, 3, 1, 100, 1),
    (20480, 3, 1, 100, 1), (40960, 3, 1, 100, 1),
]


@pytest.mark.parametrize("max_cluster", [16, 8])
@pytest.mark.parametrize("shape", SLOT_SHAPES)
def test_slot_plan_leaves_the_cache_a_pod_of_terms(shape, max_cluster):
    """The slot plan's chunk is the largest (``POD_CHUNK`` down to 1)
    whose staging leaves the term-row cache the lines of a window of one
    pod (``min(T, SPARSE_K)``), on which the kernel's windows always make
    progress; the cache holds as many lines as fit, at most T. Where not
    even one pod a chunk leaves that many, the plan is past the limit and
    the batch goes to the wide kernel."""
    n, r, sc, t, u = shape
    plan = slots_candidate(n, r, sc, t, u, max_cluster)
    cut = cluster_candidate(n, r, sc, t, u, max_cluster)
    assert (plan.cluster, plan.threads, plan.cols_per_block) == (
        cut.cluster, cut.threads, cut.cols_per_block)
    args = (r, sc, t, u, plan.cluster, plan.threads, plan.cols_per_block)
    cache = slot_cache(*args, plan.chunk)
    assert cache.need == min(t, SPARSE_K)
    assert plan.smem_bytes == slots_smem_bytes(*args, plan.chunk)
    assert cache.fixed_words % 4 == 0     # 16-byte aligned lines
    line = 3 * plan.cols_per_block + 2
    if plan.smem_bytes <= SMEM_LIMIT:
        assert 1 <= plan.chunk <= POD_CHUNK
        assert cache.need <= cache.lines <= t
        # as many lines as fit: one more would pass the limit (or T)
        assert cache.lines == t or plan.smem_bytes + 4 * line > SMEM_LIMIT
        if plan.chunk < POD_CHUNK:
            assert slots_smem_bytes(*args, plan.chunk + 1) > SMEM_LIMIT
    else:
        assert plan.chunk == 1 and cache.lines == cache.need
        assert plan_launch(n, r, sc, t, u, max_cluster,
                           packs=True).kernel == "wide"


def test_a_cache_of_every_term_keeps_the_whole_chunk():
    """Where every term's line fits beside full staging (T = 100 at 640
    columns, T = 40 at 1,408), the chunk is ``POD_CHUNK`` and no line is
    ever evicted; at 10,240 columns the cache holds 22 lines of T = 100
    (two pods' references and more), at 20,480 eight (one pod's: a window
    may wait for the one before it), and at 40,960 not eight, so those
    batches run the wide kernel."""
    for shape in ((640, 3, 1, 100, 1), (1408, 3, 2, 40, 2)):
        plan = slots_candidate(*shape)
        cache = slot_cache(*shape[1:], plan.cluster, plan.threads,
                           plan.cols_per_block, plan.chunk)
        assert plan.chunk == POD_CHUNK and cache.lines == shape[3]
    plan = slots_candidate(10240, 3, 1, 100, 1)
    assert slot_cache(3, 1, 100, 1, plan.cluster, plan.threads,
                      plan.cols_per_block, plan.chunk).lines == 22
    for n, lines in ((20480, SPARSE_K), (40960, None)):
        plan = plan_launch(n, 3, 1, 100, 1, packs=True)
        assert plan.kernel == ("slots" if lines else "wide")
        if lines:
            assert plan.chunk == POD_CHUNK and slot_cache(
                3, 1, 100, 1, plan.cluster, plan.threads,
                plan.cols_per_block, plan.chunk).lines == lines


@pytest.mark.parametrize("max_cluster", [16, 8])
@pytest.mark.parametrize("n,shards", [
    (5120, 1), (5120, 2), (5120, 4), (5120, 8), (5120, 16), (1024, 16),
    (1536, 3), (1536, 6), (5120, 5), (4096, 32), (2048, 2), (128, 4)])
def test_sharded_plan_takes_one_cluster_exactly_when_the_shards_divide_it(
        n, shards, max_cluster):
    """The sharded plan's route: one cluster (``sharded_groups`` > 0)
    exactly when the shard count divides the cluster size, each shard a
    group of ``cluster // shards`` blocks; else the global route, a
    cluster a shard cut from one shard's columns. Either fits one block's
    shared memory and covers every column."""
    nl = n // shards
    plan = wide_candidate(nl, 3, 1, 1, 1, max_cluster=max_cluster,
                          kernel="sharded", shards=shards)
    g = sharded_groups(plan, shards, n)
    assert (g > 0) == (max_cluster % shards == 0)
    assert plan.smem_bytes <= SMEM_LIMIT
    assert 1 <= plan.cluster <= max_cluster
    if g:
        assert plan.cluster == shards * g
        assert g * plan.cols_per_block >= nl
        assert (g - 1) * plan.cols_per_block < nl     # no empty block
        assert plan == wide_candidate(
            nl, 3, 1, 1, 1, max_cluster=max_cluster // shards,
            kernel="sharded")._replace(cluster=plan.cluster,
                                       smem_bytes=plan.smem_bytes)
    else:
        assert plan == wide_candidate(nl, 3, 1, 1, 1,
                                      max_cluster=max_cluster,
                                      kernel="sharded")
        assert plan.cluster * plan.cols_per_block >= nl
